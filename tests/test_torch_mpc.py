"""The port's planner (``positionbaseddynamics_tpu_torch/mpc``) against the
JAX package's ``mpc`` on the same inputs, on the CPU.

Inputs and noise come from numpy seeds or from JAX's own key splits, and
both sides take the same numbers. Tolerances: the control model exactly
(the same float32 operations in the same order); each cost term 1e-6
relative (float32 means over another summation order); the sequence
cost, the planner updates and the controller 1e-5, the repo's bar for the
port's stepper against JAX's jitted rollout (``tests/test_torch_step.py``:
XLA contracts the rollout into FMAs, which moves positions by an ulp that
the stiff cloth amplifies). The cloth is an 8×8 structured grid with
``bench.py --mpc``'s constraints and ``StepConfig`` (dt 0.01, 2 substeps,
damping 0.01)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from positionbaseddynamics_tpu import mpc as jmpc
from positionbaseddynamics_tpu.models import SceneBuilder as JBuilder
from positionbaseddynamics_tpu.solver import StepConfig as JConfig
from positionbaseddynamics_tpu.solver.state import (
    ParticleState as JParticles, SimState as JSimState)
from positionbaseddynamics_tpu_torch import mpc as tmpc
from positionbaseddynamics_tpu_torch.models import SceneBuilder as TBuilder
from positionbaseddynamics_tpu_torch.solver import StepConfig as TConfig
from positionbaseddynamics_tpu_torch.solver import make_step_fn
from positionbaseddynamics_tpu_torch.solver.state import (
    ParticleState as TParticles, SimState as TSimState)

N = 8
T = 4
K = 8
CFG = dict(dt=0.01, substeps=2, damping=0.01)   # bench.py --mpc


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _cloth(builder, **build_kw):
    b = builder()
    tm = b.add_regular_triangle_model(N, N)
    b.set_mass(tm.offset, 0.0)
    b.add_cloth_constraints(tm, method=4, distance_stiffness=1e5)
    b.add_bending_constraints(tm, method=3, stiffness=0.05)
    return b.build(**build_kw)


def _scenes():
    js, jc = _cloth(JBuilder)
    ts, tc = _cloth(TBuilder, device="cpu")
    assert jc.grid_cloths and tc.grid_cloths
    np.testing.assert_array_equal(ts.particles.x.numpy(),
                                  np.asarray(js.particles.x))
    return js, jc, ts, tc


def _terms(x0):
    """bench.py --mpc's cost: control effort and the pin's distance to a
    target 0.5 right and up of it, plus the free corner's."""
    pin, free = 0, N * N - 1
    target = x0[pin] + np.float32([0.5, 0.5, 0.0])
    out = {}
    for name, m in (("j", jmpc), ("t", tmpc)):
        out[name] = dict(
            running_cost=m.combine(m.control_effort(1e-3),
                                   m.as_running(m.particle_target(
                                       [free], target, weight=0.1))),
            terminal_cost=m.particle_target([pin], target))
    return out


def _random_state(rng, n, masses):
    x = rng.normal(0.0, 1.0, (n, 3)).astype(np.float32)
    v = rng.normal(0.0, 1.0, (n, 3)).astype(np.float32)
    js = JSimState.create(JParticles.create(x, masses))
    js = dataclasses.replace(js, particles=dataclasses.replace(
        js.particles, v=jnp.asarray(v)))
    ts = TSimState.create(TParticles.create(x, masses, device="cpu"))
    ts = dataclasses.replace(ts, particles=dataclasses.replace(
        ts.particles, v=torch.from_numpy(v)))
    return js, ts


@pytest.mark.parametrize("max_speed", [np.inf, 0.7])
@pytest.mark.parametrize("k", [None, 5])
def test_pin_velocity_control_matches_jax(max_speed, k):
    rng = np.random.default_rng(1)
    n = 10
    masses = np.ones(n, np.float32)
    masses[[2, 7]] = 0.0
    idx = (2, 7, 2)                 # a repeated pin adds twice, as in JAX
    js, ts = _random_state(rng, n, masses)
    jc = jmpc.PinVelocityControl(indices=idx, max_speed=max_speed)
    tc = tmpc.PinVelocityControl(indices=idx, max_speed=max_speed)
    assert tc.u_dim == jc.u_dim == 9
    shape = (jc.u_dim,) if k is None else (k, jc.u_dim)
    u = rng.normal(0.0, 1.0, shape).astype(np.float32)
    dt = 0.01
    if k is None:
        xj = np.asarray(jc.apply(js, jnp.asarray(u), dt).particles.x)
        ts_in = ts
    else:
        xs = rng.normal(0.0, 1.0, (k, n, 3)).astype(np.float32)

        def one(x, uu):
            s = dataclasses.replace(js, particles=dataclasses.replace(
                js.particles, x=x))
            return jc.apply(s, uu, dt).particles.x

        xj = np.asarray(jax.vmap(one)(jnp.asarray(xs), jnp.asarray(u)))
        ts_in = dataclasses.replace(ts, particles=dataclasses.replace(
            ts.particles, x=torch.from_numpy(xs)))
    xt = tc.apply(ts_in, torch.from_numpy(u), dt).particles.x
    np.testing.assert_array_equal(xt.numpy(), xj)
    if np.isfinite(max_speed):       # the clamp took effect somewhere
        moved = np.abs(xt.numpy() - ts_in.particles.x.numpy()).max()
        assert 0.0 < moved <= 2 * max_speed * dt + 1e-7


def test_pin_velocity_control_with_one_u_moves_every_rollout():
    rng = np.random.default_rng(2)
    masses = np.ones(6, np.float32)
    _, ts = _random_state(rng, 6, masses)
    xs = torch.from_numpy(rng.normal(0.0, 1.0, (3, 6, 3)).astype(np.float32))
    ts = dataclasses.replace(ts, particles=dataclasses.replace(
        ts.particles, x=xs))
    u = torch.tensor([1.0, 2.0, 3.0])
    x = tmpc.PinVelocityControl(indices=(4,)).apply(ts, u, 0.5).particles.x
    np.testing.assert_array_equal(
        x[:, 4].numpy(), (xs[:, 4] + torch.tensor([0.5, 1.0, 1.5])).numpy())
    assert torch.equal(torch.cat([x[:, :4], x[:, 5:]], 1),
                       torch.cat([xs[:, :4], xs[:, 5:]], 1))


@pytest.mark.parametrize("term", ["particle_target", "particle_target_rows",
                                  "velocity_penalty", "control_effort",
                                  "as_running", "combine"])
@pytest.mark.parametrize("k", [None, 6])
def test_cost_terms_match_jax(term, k):
    rng = np.random.default_rng(3)
    n = 12
    masses = np.ones(n, np.float32)
    js, ts = _random_state(rng, n, masses)
    tgt3 = rng.normal(0.0, 1.0, 3).astype(np.float32)
    tgt_rows = rng.normal(0.0, 1.0, (3, 3)).astype(np.float32)

    def build(m):
        pt = m.particle_target([1, 5, 9], tgt3, weight=0.7)
        return {"particle_target": (pt, False),
                "particle_target_rows": (m.particle_target(
                    [0, 4, 11], tgt_rows, weight=2.0), False),
                "velocity_penalty": (m.velocity_penalty(0.3), False),
                "control_effort": (m.control_effort(1e-3), True),
                "as_running": (m.as_running(pt), True),
                "combine": (m.combine(m.control_effort(0.5), None,
                                      m.as_running(m.velocity_penalty(0.2)),
                                      m.as_running(pt)), True)}[term]

    (jf, running), (tf, _) = build(jmpc), build(tmpc)
    lead = () if k is None else (k,)
    x = rng.normal(0.0, 1.0, lead + (n, 3)).astype(np.float32)
    v = rng.normal(0.0, 1.0, lead + (n, 3)).astype(np.float32)
    u = rng.normal(0.0, 1.0, lead + (6,)).astype(np.float32)

    def jcost(xx, vv, uu):
        s = dataclasses.replace(js, particles=dataclasses.replace(
            js.particles, x=xx, v=vv))
        return jf(s, uu) if running else jf(s)

    args = tuple(jnp.asarray(a) for a in (x, v, u))
    cj = np.asarray(jcost(*args) if k is None else jax.vmap(jcost)(*args))
    st = dataclasses.replace(ts, particles=dataclasses.replace(
        ts.particles, x=torch.from_numpy(x), v=torch.from_numpy(v)))
    ct = tf(st, torch.from_numpy(u)) if running else tf(st)
    assert tuple(ct.shape) == lead
    assert _rel(ct.numpy(), cj) <= 1e-6


@pytest.mark.parametrize("k", [None, 3])
def test_sequence_cost_matches_jax(k):
    js, jc, ts, tc = _scenes()
    terms = _terms(np.asarray(js.particles.x))
    ctrl_j = jmpc.PinVelocityControl(indices=(0,), max_speed=2.0)
    ctrl_t = tmpc.PinVelocityControl(indices=(0,), max_speed=2.0)
    jseq = jmpc.make_sequence_cost(jc, JConfig(**CFG), ctrl_j, **terms["j"])
    tseq = tmpc.make_sequence_cost(tc, TConfig(**CFG), ctrl_t, **terms["t"],
                                   device="cpu")
    assert tseq.path == "torch_stencil"
    rng = np.random.default_rng(4)
    lead = () if k is None else (k,)
    u = rng.normal(0.0, 1.5, lead + (T, 3)).astype(np.float32)
    if k is None:
        cj, sj = jseq(js, jnp.asarray(u))
        xj = np.asarray(sj.particles.x)
    else:
        cj, xj = jax.vmap(lambda uu: (lambda c, s: (c, s.particles.x))(
            *jseq(js, uu)))(jnp.asarray(u))
    ct, st = tseq(ts, torch.from_numpy(u))
    assert tuple(ct.shape) == lead
    assert st.particles.x.shape == lead + (N * N, 3)
    assert _rel(ct.numpy(), cj) <= 1e-5
    assert np.abs(st.particles.x.numpy() - np.asarray(xj)).max() <= 1e-5
    # the pin moved only through the control
    assert np.abs(st.particles.x.numpy()[..., 0, :]
                  - ts.particles.x.numpy()[0]).max() > 1e-3


def _seq_cost_against_jax(js, jc, ts, tc, control, k, seed, cfg_kw,
                          field):
    """``make_sequence_cost`` over K rollouts from one scene, with
    ``control`` (``(j, t)``), the control effort and the driven
    particle's distance to a target 0.2 right and 0.1 up of it, against
    JAX's ``jax.vmap``-ped cost on the same controls: costs 1e-5 relative,
    ``field`` (``"x"`` or ``"q"``) 1e-5. Returns the port's final
    state."""
    idx = control[1].indices[0]
    target = np.asarray(js.particles.x)[idx] + np.float32([0.2, 0.1, 0.0])
    terms = {name: dict(running_cost=m.control_effort(1e-3),
                        terminal_cost=m.particle_target([idx], target))
             for name, m in (("j", jmpc), ("t", tmpc))}
    jseq = jmpc.make_sequence_cost(jc, JConfig(**cfg_kw), control[0],
                                   **terms["j"])
    tseq = tmpc.make_sequence_cost(tc, TConfig(**cfg_kw), control[1],
                                   device="cpu", **terms["t"])
    u = np.random.default_rng(seed).normal(
        0.0, 0.5, (k, T, control[1].u_dim)).astype(np.float32)

    def pick(s):
        return s.particles.x if field == "x" else s.orientations.q

    cj, fj = jax.jit(jax.vmap(lambda uu: (lambda c, s: (c, pick(s)))(
        *jseq(js, uu))))(jnp.asarray(u))
    ct, st = tseq(ts, torch.from_numpy(u))
    assert ct.shape == (k,)
    assert _rel(ct.numpy(), cj) <= 1e-5
    assert np.abs(pick(st).numpy() - np.asarray(fj)).max() <= 1e-5
    assert np.abs(st.particles.x.numpy() - np.asarray(
        jax.vmap(lambda uu: jseq(js, uu)[1].particles.x)(jnp.asarray(u)))
        ).max() <= 1e-5
    return tseq, st


def test_sequence_cost_over_a_structured_bar_matches_jax():
    """Fault C-1 repaired: ``make_sequence_cost`` on a 6×3×3 structured tet
    bar (the grid-tet stencil path, K = 4 rollouts on a leading axis),
    against JAX's ``vmap``-ped cost, the corner particle driven by a
    ``PinVelocityControl``."""
    def bar(builder, **kw):
        b = builder()
        tm = b.add_regular_tet_model(6, 3, 3, scale=(1.5, 0.5, 0.5))
        for j in range(9):
            b.set_mass(tm.offset + j, 0.0)
        b.add_solid_constraints(tm, method=3, stiffness=1e4,
                                poisson_ratio=0.3)
        return b.build(**kw)

    js, jc = bar(JBuilder)
    ts, tc = bar(TBuilder, device="cpu")
    assert jc.grid_tets and tc.grid_tets
    tip = 6 * 9 - 1
    ctl = (jmpc.PinVelocityControl(indices=(tip,), max_speed=2.0),
           tmpc.PinVelocityControl(indices=(tip,), max_speed=2.0))
    tseq, _ = _seq_cost_against_jax(js, jc, ts, tc, ctl, 4, 21, {}, "x")
    assert tseq.path == "torch_stencil"


def test_sequence_cost_over_rods_matches_jax():
    """``make_sequence_cost`` over K = 4 rollouts of 3 lattice rods, one
    rod's free end driven by a ``PinVelocityControl``: the orientations
    carry the rollout axis through the substeps."""
    import torch_rod_scenes as rscenes

    js, jc = rscenes.rods("jax", n_rods=3, n=8)
    ts, tc = rscenes.rods("torch", n_rods=3, n=8)
    assert tc.rod_lattices
    ctl = (jmpc.PinVelocityControl(indices=(7,), max_speed=2.0),
           tmpc.PinVelocityControl(indices=(7,), max_speed=2.0))
    tseq, st = _seq_cost_against_jax(js, jc, ts, tc, ctl, 4, 22, {}, "q")
    assert tseq.path == "torch_rods"
    assert st.orientations.q.shape == (4,) + tuple(ts.orientations.q.shape)


def _planner_inputs():
    js, jc, ts, tc = _scenes()
    terms = _terms(np.asarray(js.particles.x))
    jseq = jmpc.make_sequence_cost(
        jc, JConfig(**CFG), jmpc.PinVelocityControl(indices=(0,),
                                                    max_speed=2.0),
        **terms["j"])
    tseq = tmpc.make_sequence_cost(
        tc, TConfig(**CFG), tmpc.PinVelocityControl(indices=(0,),
                                                    max_speed=2.0),
        **terms["t"], device="cpu")
    return js, ts, jseq, tseq


def test_mppi_update_matches_jax_on_fed_noise():
    js, ts, jseq, tseq = _planner_inputs()
    mcfg = dict(horizon=T, num_samples=K, sigma=1.0, temperature=0.1)
    jcfg, tcfg = jmpc.MPPIConfig(**mcfg), tmpc.MPPIConfig(**mcfg)
    nominal = np.random.default_rng(5).normal(0, 0.3, (T, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(7)
    eps = np.array(jcfg.sigma * jax.random.normal(
        key, (K, T, 3), jnp.float32))
    nj, cj = jmpc.mppi_update(key, js, jnp.asarray(nominal), jseq, jcfg)
    nt, ct = tmpc.mppi_update(ts, torch.from_numpy(nominal), tseq, tcfg,
                              eps=torch.from_numpy(eps))
    assert ct.shape == (K,)
    assert _rel(ct.numpy(), cj) <= 1e-5
    assert np.abs(nt.numpy() - np.asarray(nj)).max() <= 1e-5
    assert np.abs(nt.numpy() - nominal).max() > 1e-3


def test_cem_update_matches_jax_on_fed_noise():
    js, ts, jseq, tseq = _planner_inputs()
    ccfg = dict(horizon=T, num_samples=K, elite_frac=0.25, init_sigma=1.0,
                min_sigma=0.05)
    jcfg, tcfg = jmpc.CEMConfig(**ccfg), tmpc.CEMConfig(**ccfg)
    rng = np.random.default_rng(6)
    mean = rng.normal(0, 0.3, (T, 3)).astype(np.float32)
    sigma = rng.uniform(0.5, 1.5, (T, 3)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    eps = np.array(jax.random.normal(key, (K, T, 3), jnp.float32))
    mj, sj, cj = jmpc.cem_update(key, js, jnp.asarray(mean),
                                 jnp.asarray(sigma), jseq, jcfg)
    mt, st, ct = tmpc.cem_update(ts, torch.from_numpy(mean),
                                 torch.from_numpy(sigma), tseq, tcfg,
                                 eps=torch.from_numpy(eps))
    assert _rel(ct.numpy(), cj) <= 1e-5
    n_elite = max(1, int(jcfg.elite_frac * K))
    assert n_elite == 2
    np.testing.assert_array_equal(
        torch.topk(-ct, n_elite).indices.numpy(),
        np.asarray(jax.lax.top_k(-cj, n_elite)[1]))
    assert np.abs(mt.numpy() - np.asarray(mj)).max() <= 1e-5
    assert np.abs(st.numpy() - np.asarray(sj)).max() <= 1e-5
    assert (st.numpy() >= jcfg.min_sigma).all()


def _controller_noise(key, n_steps, pcfg, scale, u_dim=3):
    """The draws JAX's controller makes from ``key``: one key a step
    (``planners.py:176``), split into one a planner update
    (``planners.py:115, :127``)."""
    out = []
    for k in jax.random.split(key, n_steps):
        out.append([scale * jax.random.normal(
            kk, (pcfg.num_samples, pcfg.horizon, u_dim), jnp.float32)
            for kk in jax.random.split(k, pcfg.plan_iters)])
    return np.asarray(out)


@pytest.mark.parametrize("planner", ["mppi", "cem"])
def test_controller_matches_jax_on_fed_noise(planner):
    js, jc, ts, tc = _scenes()
    terms = _terms(np.asarray(js.particles.x))
    if planner == "mppi":
        pc = dict(horizon=T, num_samples=K, sigma=1.0, temperature=0.1,
                  plan_iters=2)
        jcfg, tcfg = jmpc.MPPIConfig(**pc), tmpc.MPPIConfig(**pc)
        scale = jcfg.sigma
    else:
        pc = dict(horizon=T, num_samples=K, elite_frac=0.25, plan_iters=2)
        jcfg, tcfg = jmpc.CEMConfig(**pc), tmpc.CEMConfig(**pc)
        scale = 1.0
    n_steps = 3
    jrun = jmpc.make_mpc_controller(
        jc, JConfig(**CFG), jmpc.PinVelocityControl(indices=(0,),
                                                    max_speed=2.0),
        planner=planner, planner_cfg=jcfg, **terms["j"])
    trun = tmpc.make_mpc_controller(
        tc, TConfig(**CFG), tmpc.PinVelocityControl(indices=(0,),
                                                    max_speed=2.0),
        planner=planner, planner_cfg=tcfg, device="cpu", **terms["t"])
    key = jax.random.PRNGKey(11)
    noise = _controller_noise(key, n_steps, jcfg, scale)
    fj, ij = jrun(key, js, n_steps)
    ft, it = trun(ts, n_steps, noise=torch.from_numpy(noise))
    assert it["controls"].shape == (n_steps, 3)
    assert np.abs(it["controls"].numpy()
                  - np.asarray(ij["controls"])).max() <= 1e-5
    assert _rel(it["cost"].numpy(), ij["cost"]) <= 1e-5
    assert np.abs(ft.particles.x.numpy()
                  - np.asarray(fj.particles.x)).max() <= 1e-5
    assert ft.particles.x.shape == (N * N, 3)


def test_mppi_steers_a_structured_cloth_with_a_generator():
    """In the spirit of JAX's ``test_mppi_cloth_pin_steering`` on the
    structured grid: MPPI drags the pinned corner so that the opposite,
    free corner ends near a target that the hanging cloth reaches by
    translation; the controlled error beats the uncontrolled one. The
    cloth swings down from its plane for ~1 s under this damping, so it
    settles for 1500 steps (7.5 s) first, and the planner looks 30 steps
    ahead; seeds 3–5 give 0.46–0.50 of the uncontrolled error."""
    n = 6
    b = TBuilder()
    tm = b.add_regular_triangle_model(n, n, scale=(1.0, 1.0))
    pin = tm.offset
    b.set_mass(pin, 0.0)
    b.add_cloth_constraints(tm, method=4, distance_stiffness=1e5)
    state, cset = b.build(device="cpu")
    assert cset.grid_cloths
    cfg = TConfig(substeps=2, damping=0.05)
    free = tm.offset + n * n - 1
    step = make_step_fn(cset, cfg, device="cpu")
    for _ in range(1500):                      # settle the hang
        state = step(state)
    delta = np.float32([0.4, 0.3, 0.0])
    target = state.particles.x[free].numpy() + delta
    control = tmpc.PinVelocityControl(indices=(pin,), max_speed=4.0)
    run = tmpc.make_mpc_controller(
        cset, cfg, control,
        running_cost=tmpc.combine(
            tmpc.as_running(tmpc.particle_target([free], target)),
            tmpc.control_effort(1e-4)),
        terminal_cost=tmpc.particle_target([free], target, weight=5.0),
        planner="mppi",
        planner_cfg=tmpc.MPPIConfig(horizon=30, num_samples=24, sigma=2.0,
                                    temperature=0.05, plan_iters=1),
        device="cpu")
    gen = torch.Generator(device="cpu").manual_seed(3)
    final, info = run(state, 100, generator=gen)
    err_ctrl = np.linalg.norm(final.particles.x[free].numpy() - target)
    base = state
    for _ in range(100):
        base = step(base)
    err_base = np.linalg.norm(base.particles.x[free].numpy() - target)
    assert torch.isfinite(info["cost"]).all()
    assert err_ctrl < 0.6 * err_base, (err_ctrl, err_base)


def test_mppi_update_on_the_unstructured_pin_steering_cloth_matches_jax():
    """The counterpart of JAX's ``test_mppi_cloth_pin_steering``: its 6×6
    cloth built with ``use_structured_grid=False`` (XPBD distance
    batches), settled 150 steps, then one controller step of its MPPI
    (horizon 30, 48 samples, σ 2, two updates) fed JAX's key splits.

    The 48 sampled sequences' costs, the planned cost and the stepped
    state agree within 1e-5 (the planner's bar, relative for costs). The
    controls are held to 1e-3: MPPI weighs a sample by ``exp(−c/T)`` at
    temperature T = 0.05, so a cost difference δ moves its weight by δ/T,
    20δ here; costs of ~9 within the 1e-5 relative bar may differ by 9e-5
    and move a weight by up to 2e-3 relative (ROADMAP §C)."""
    n = 6

    def scene(builder, **kw):
        b = builder(use_structured_grid=False)
        tm = b.add_regular_triangle_model(n, n, scale=(1.0, 1.0))
        b.set_mass(tm.offset, 0.0)
        b.add_cloth_constraints(tm, method=4, distance_stiffness=1e5)
        return b.build(**kw)

    js, jc = scene(JBuilder)
    ts, tc = scene(TBuilder, device="cpu")
    assert tc.distance is not None and not tc.grid_cloths
    kw = dict(substeps=2, damping=0.05)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    from positionbaseddynamics_tpu.solver import rollout as jrollout
    from positionbaseddynamics_tpu_torch.solver import rollout as trollout
    js, _ = jax.jit(lambda s: jrollout(s, jc, jcfg, 150))(js)
    ts, _ = trollout(ts, tc, tcfg, 150)
    assert np.abs(ts.particles.x.numpy()
                  - np.asarray(js.particles.x)).max() <= 1e-5
    free = n * n - 1
    target = np.asarray(js.particles.x[free]) + np.float32([0.4, 0.3, 0.0])
    pc = dict(horizon=30, num_samples=48, sigma=2.0, temperature=0.05,
              plan_iters=2)
    jp, tp = jmpc.MPPIConfig(**pc), tmpc.MPPIConfig(**pc)
    runs, seqs = {}, {}
    for name, m, c, cfg, p, extra in (("j", jmpc, jc, jcfg, jp, {}),
                                      ("t", tmpc, tc, tcfg, tp,
                                       dict(device="cpu"))):
        terms = dict(
            running_cost=m.combine(
                m.as_running(m.particle_target([free], target)),
                m.control_effort(1e-4)),
            terminal_cost=m.particle_target([free], target, weight=5.0))
        control = m.PinVelocityControl(indices=(0,), max_speed=4.0)
        runs[name] = m.make_mpc_controller(c, cfg, control, planner="mppi",
                                           planner_cfg=p, **terms, **extra)
        seqs[name] = m.make_sequence_cost(c, cfg, control, **terms, **extra)
    key = jax.random.PRNGKey(3)
    noise = _controller_noise(key, 1, jp, jp.sigma)
    # the first update's samples: the zero nominal plus the fed noise
    u = noise[0, 0]
    cj = jax.jit(jax.vmap(lambda uu: seqs["j"](js, uu)[0]))(jnp.asarray(u))
    ct = seqs["t"](ts, torch.from_numpy(u))
    ct = ct[0] if isinstance(ct, tuple) else ct
    cost_rel = _rel(ct.numpy(), cj)
    fj, ij = runs["j"](key, js, 1)
    ft, it = runs["t"](ts, 1, noise=torch.from_numpy(noise))
    du = np.abs(it["controls"].numpy() - np.asarray(ij["controls"])).max()
    print(f"sampled costs {cost_rel!r} relative, controls {du!r}")
    assert ct.shape == (48,) and cost_rel <= 1e-5
    assert du <= 1e-3
    assert _rel(it["cost"].numpy(), ij["cost"]) <= 1e-5
    assert np.abs(ft.particles.x.numpy()
                  - np.asarray(fj.particles.x)).max() <= 1e-5
    assert np.abs(np.asarray(ij["controls"])).max() > 1e-2


def _obstacles(m):
    """A sphere, a box turned inside out and a grid obstacle of package
    ``m``'s ``SDFShape``, placed by translations."""
    from importlib import import_module
    sdf = import_module(m.__name__.rsplit(".", 1)[0] + ".collision.sdf")
    vals = np.random.default_rng(9).normal(0.3, 0.2, (6, 5, 7)).astype(
        np.float32)
    return ([sdf.SDFShape.sphere(0.4), sdf.SDFShape.box((0.3, 0.2, 0.5)),
             sdf.SDFShape.grid(vals, (-1.0, -1.0, -1.0), (2.0, 2.0, 2.0))],
            [(0.2, 0.1, -0.1), (-0.3, 0.0, 0.2), (0.0, 0.0, 0.0)])


@pytest.mark.parametrize("make", [
    lambda m: m.sdf_obstacle(*_obstacles(m)[:1], weight=3.0, margin=0.1,
                             translations=_obstacles(m)[1], subset=[0, 2, 5,
                                                                    7]),
    lambda m: m.rigid_sdf_obstacle(_obstacles(m)[0], 1, radius=0.3,
                                   weight=500.0,
                                   translations=_obstacles(m)[1])],
    ids=["sdf_obstacle", "rigid_sdf_obstacle"])
def test_unported_terms_raise_naming_their_slice(make):
    """The SDF obstacle terms (ported with collision): penetration
    penalties of particles (a subset, with a margin) and of a rigid body's
    bounding sphere against three placed obstacles, over one state and K 5
    rollouts, 1e-6 relative to JAX's."""
    from positionbaseddynamics_tpu.solver.state import RigidState as JRigid
    from positionbaseddynamics_tpu_torch.solver.state import (
        RigidState as TRigid)

    rng = np.random.default_rng(15)
    jterm, tterm = make(jmpc), make(tmpc)
    for k in (None, 5):
        lead = () if k is None else (k,)
        x = rng.uniform(-0.8, 0.8, lead + (8, 3)).astype(np.float32)
        rx = rng.uniform(-0.8, 0.8, lead + (3, 3)).astype(np.float32)
        u = np.zeros(lead + (3,), np.float32)

        def jcost(xx, rr, uu):
            r = JRigid.create(rr, np.tile([1.0, 0, 0, 0], (3, 1)),
                              np.ones(3), np.ones((3, 3)))
            p = JParticles.create(xx, np.ones(8))
            return jterm(JSimState.create(p, rigid=r), uu)

        args = (jnp.asarray(x), jnp.asarray(rx), jnp.asarray(u))
        cj = np.asarray(jcost(*args) if k is None
                        else jax.vmap(jcost)(*args))
        r = dataclasses.replace(TRigid.create(
            np.zeros((3, 3)), np.tile([1.0, 0, 0, 0], (3, 1)), np.ones(3),
            np.ones((3, 3)), device="cpu"), x=torch.from_numpy(rx))
        st = TSimState(particles=dataclasses.replace(TParticles.create(
            np.zeros((8, 3)), np.ones(8), device="cpu"),
            x=torch.from_numpy(x)), orientations=None, rigid=r,
            time=torch.zeros(()))
        ct = tterm(st, torch.from_numpy(u))
        assert tuple(ct.shape) == lead
        assert (cj > 0).any()
        assert _rel(ct.numpy(), cj) <= 1e-6


def test_pipeline_raises_naming_its_slice():
    """``make_sequence_cost(pipeline=)`` (ported with collision) over K 4
    rollouts of the 12×12 cloth landing on the sphere, with the
    particle–rigid contacts, the SDF obstacle term on the cloth and the
    corner pin's velocity as the control: costs 1e-5 relative and
    positions 1e-5 from JAX's vmapped sequence cost, overflow 0; and
    ``make_mpc_controller(pipeline=)`` runs a step on it."""
    import torch_collision_scenes as scenes
    from positionbaseddynamics_tpu.collision.sdf import SDFShape as JShape
    from positionbaseddynamics_tpu_torch.collision.sdf import (
        SDFShape as TShape)

    js, jc, jp = scenes.cloth_on_sphere("jax", height=0.63)
    ts, tc, tp = scenes.cloth_on_sphere("torch", height=0.63)
    terms = {}
    for name, m, shape in (("j", jmpc, JShape), ("t", tmpc, TShape)):
        terms[name] = dict(
            running_cost=m.combine(
                m.control_effort(1e-3),
                m.sdf_obstacle([shape.sphere(0.6)], weight=10.0,
                               margin=0.05)),
            terminal_cost=m.velocity_penalty(0.1))
    cj_ = jmpc.PinVelocityControl(indices=(0,), max_speed=2.0)
    ct_ = tmpc.PinVelocityControl(indices=(0,), max_speed=2.0)
    jseq = jmpc.make_sequence_cost(jc, JConfig(), cj_, pipeline=jp,
                                   **terms["j"])
    tseq = tmpc.make_sequence_cost(tc, TConfig(), ct_, pipeline=tp,
                                   device="cpu", **terms["t"])
    assert tseq.path == "torch_rigid"
    u = np.random.default_rng(16).normal(0.0, 1.0, (4, 16, 3)).astype(
        np.float32)
    cj, xj, oj = jax.vmap(lambda uu: (lambda c, s: (
        c, s.particles.x, s.overflow))(*jseq(js, uu)))(jnp.asarray(u))
    ct, st = tseq(ts, torch.from_numpy(u))
    assert ct.shape == (4,)
    assert _rel(ct.numpy(), cj) <= 1e-5
    assert np.abs(st.particles.x.numpy() - np.asarray(xj)).max() <= 1e-5
    assert float(st.overflow.max()) == float(np.asarray(oj).max()) == 0.0
    # the cloth reached the sphere in every rollout
    assert (np.linalg.norm(st.particles.x.numpy(), axis=-1).min(-1)
            < 0.625).all()
    run = tmpc.make_mpc_controller(
        tc, TConfig(), ct_, planner="mppi", pipeline=tp, device="cpu",
        planner_cfg=tmpc.MPPIConfig(horizon=2, num_samples=3,
                                    plan_iters=1), **terms["t"])
    fin, info = run(ts, 1, generator=torch.Generator().manual_seed(0))
    assert info["controls"].shape == (1, 3)
    assert torch.isfinite(fin.particles.x).all()


# ---------------------------------------------------------------------------
# The rigid terms, on JAX's ``_free_rigid_scene`` (tests/test_mpc.py:17-23):
# one dynamic body at the origin, an inert pinned particle, no constraint;
# StepConfig(substeps=2) and σ 20, λ 0.05 as JAX's rigid MPPI tests.
# ---------------------------------------------------------------------------

RIGID_CFG = dict(substeps=2)
RIGID_TARGET = (1.0, 0.5, 0.0)


def _free_rigid_scenes():
    from positionbaseddynamics_tpu.solver.constraints import (
        ConstraintSet as JSet)
    from positionbaseddynamics_tpu.solver.state import RigidState as JRigid
    from positionbaseddynamics_tpu_torch.solver.constraints import (
        ConstraintSet as TSet)
    from positionbaseddynamics_tpu_torch.solver.state import (
        RigidState as TRigid)

    args = dict(x=np.zeros((1, 3)), q=np.array([[1.0, 0, 0, 0]]),
                masses=np.ones((1,)), inertia_diag=np.ones((1, 3)))
    js = JSimState.create(JParticles.create(np.zeros((1, 3)), np.zeros((1,))),
                          rigid=JRigid.create(**args))
    ts = TSimState.create(
        TParticles.create(np.zeros((1, 3)), np.zeros((1,)), device="cpu"),
        rigid=TRigid.create(**args, device="cpu"))
    return js, JSet(), ts, TSet(n_particles=1, n_rigid=1)


def _rigid_terms(m):
    return dict(
        running_cost=m.combine(m.as_running(m.rigid_target(
            0, RIGID_TARGET, weight=1.0)), m.control_effort(1e-6)),
        terminal_cost=m.rigid_target(0, RIGID_TARGET, weight=10.0))


def _random_rigid(rng, k):
    """``k`` rollouts of three bodies (``None``: one state) with random
    positions, velocities and spins, as numpy float32."""
    lead = () if k is None else (k,)
    return {f: rng.normal(0.0, 1.0, lead + (3, 3)).astype(np.float32)
            for f in ("x", "v", "omega")}


@pytest.mark.parametrize("k", [None, 4])
@pytest.mark.parametrize("max_force", [np.inf, 0.7])
def test_rigid_wrench_control_matches_jax(k, max_force):
    """Force and torque set on the controlled bodies, zero elsewhere,
    clipped elementwise when ``max_force`` is finite: bit for bit."""
    from positionbaseddynamics_tpu.solver.state import RigidState as JRigid
    from positionbaseddynamics_tpu_torch.solver.state import (
        RigidState as TRigid)

    rng = np.random.default_rng(12)
    lead = () if k is None else (k,)
    args = dict(x=np.zeros((3, 3)), q=np.tile([1.0, 0, 0, 0], (3, 1)),
                masses=np.ones((3,)), inertia_diag=np.ones((3, 3)))
    jr, tr = JRigid.create(**args), TRigid.create(**args, device="cpu")
    pj = JParticles.create(np.zeros((1, 3)), np.zeros((1,)))
    pt = TParticles.create(np.zeros((1, 3)), np.zeros((1,)), device="cpu")
    u = rng.normal(0.0, 1.0, lead + (12,)).astype(np.float32)
    cj = jmpc.RigidWrenchControl(body_indices=(2, 0), max_force=max_force)
    ct = tmpc.RigidWrenchControl(body_indices=(2, 0), max_force=max_force)
    assert ct.u_dim == cj.u_dim == 12

    def jax_apply(uu):
        s = cj.apply(JSimState.create(pj, rigid=jr), uu, 0.01).rigid
        return s.ext_force, s.ext_torque

    if k is None:
        fj, tj = jax_apply(jnp.asarray(u))
        st = TSimState.create(pt, rigid=tr)
    else:
        fj, tj = jax.vmap(jax_apply)(jnp.asarray(u))
        st = dataclasses.replace(TSimState.create(pt, rigid=tr),
                                 rigid=dataclasses.replace(tr, **{
                                     f: getattr(tr, f).expand(
                                         k, *getattr(tr, f).shape).clone()
                                     for f in ("x", "v", "q", "omega",
                                               "ext_force",
                                               "ext_torque")}))
    out = ct.apply(st, torch.from_numpy(u), 0.01).rigid
    np.testing.assert_array_equal(out.ext_force.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(out.ext_torque.numpy(), np.asarray(tj))
    assert not out.ext_force[..., 1, :].any()


@pytest.mark.parametrize("k", [None, 5])
def test_rigid_target_matches_jax(k):
    rng = np.random.default_rng(13)
    x = _random_rigid(rng, k)["x"]
    from positionbaseddynamics_tpu.solver.state import RigidState as JRigid
    jterm = jmpc.rigid_target(1, (0.3, -0.2, 1.0), weight=2.5)
    tterm = tmpc.rigid_target(1, (0.3, -0.2, 1.0), weight=2.5)

    def jcost(xx):
        r = JRigid.create(xx, np.tile([1.0, 0, 0, 0], (3, 1)), np.ones(3),
                          np.ones((3, 3)))
        return jterm(JSimState(particles=None, orientations=None, rigid=r,
                               time=jnp.float32(0.0)))

    cj = jcost(jnp.asarray(x)) if k is None else jax.vmap(jcost)(
        jnp.asarray(x))
    from positionbaseddynamics_tpu_torch.solver.state import (
        RigidState as TRigid)
    r = dataclasses.replace(TRigid.create(np.zeros((3, 3)), np.tile(
        [1.0, 0, 0, 0], (3, 1)), np.ones(3), np.ones((3, 3)), device="cpu"),
        x=torch.from_numpy(x))
    ct = tterm(TSimState(particles=None, orientations=None, rigid=r,
                         time=torch.zeros(())))
    assert tuple(ct.shape) == (() if k is None else (k,))
    assert _rel(ct.numpy(), cj) <= 1e-6


def test_rigid_sequence_cost_and_mppi_update_match_jax_on_fed_noise():
    """``make_sequence_cost`` over K rollouts of the free body (the state of
    one scene expanded to K) and one MPPI update fed JAX's draw: costs 1e-5
    relative, the update 1e-3 (ROADMAP §C: a cost difference δ moves a
    weight by δ/λ, λ 0.05)."""
    js, jc, ts, tc = _free_rigid_scenes()
    jctl = jmpc.RigidWrenchControl(body_indices=(0,), max_force=120.0)
    tctl = tmpc.RigidWrenchControl(body_indices=(0,), max_force=120.0)
    jseq = jmpc.make_sequence_cost(jc, JConfig(**RIGID_CFG), jctl,
                                   **_rigid_terms(jmpc))
    tseq = tmpc.make_sequence_cost(tc, TConfig(**RIGID_CFG), tctl,
                                   **_rigid_terms(tmpc), device="cpu")
    assert tseq.path == "torch_rigid"
    pc = dict(horizon=8, num_samples=16, sigma=20.0, temperature=0.05)
    jcfg, tcfg = jmpc.MPPIConfig(**pc), tmpc.MPPIConfig(**pc)
    nominal = np.random.default_rng(14).normal(0, 5.0, (8, 6)).astype(
        np.float32)
    key = jax.random.PRNGKey(3)
    eps = np.array(jcfg.sigma * jax.random.normal(key, (16, 8, 6),
                                                   jnp.float32))
    cj, xj = jax.vmap(lambda uu: (lambda c, s: (c, s.rigid.x))(
        *jseq(js, uu)))(jnp.asarray(nominal + eps))
    ct, st = tseq(ts, torch.from_numpy(nominal + eps))
    assert ct.shape == (16,) and st.rigid.x.shape == (16, 1, 3)
    assert st.rigid.inv_mass.shape == (1,)       # shared, not expanded
    assert _rel(ct.numpy(), cj) <= 1e-5
    assert np.abs(st.rigid.x.numpy() - np.asarray(xj)).max() <= 1e-5
    nj, cuj = jmpc.mppi_update(key, js, jnp.asarray(nominal), jseq, jcfg)
    nt, cut = tmpc.mppi_update(ts, torch.from_numpy(nominal), tseq, tcfg,
                               eps=torch.from_numpy(eps))
    assert _rel(cut.numpy(), cuj) <= 1e-5
    assert np.abs(nt.numpy() - np.asarray(nj)).max() <= 1e-3
    assert np.abs(nt.numpy() - nominal).max() > 1e-2


def test_rigid_mpc_controller_matches_jax_on_fed_noise():
    """``make_mpc_controller`` on the free body, fed the draws JAX's
    controller makes from its key: 3 steps of 2 MPPI updates at K 16; the
    executed controls (updates) 1e-3, costs 1e-5 relative, the state
    1e-5."""
    js, jc, ts, tc = _free_rigid_scenes()
    pc = dict(horizon=6, num_samples=16, sigma=20.0, temperature=0.05,
              plan_iters=2)
    jcfg, tcfg = jmpc.MPPIConfig(**pc), tmpc.MPPIConfig(**pc)
    jrun = jmpc.make_mpc_controller(
        jc, JConfig(**RIGID_CFG),
        jmpc.RigidWrenchControl(body_indices=(0,), max_force=120.0),
        planner="mppi", planner_cfg=jcfg, **_rigid_terms(jmpc))
    trun = tmpc.make_mpc_controller(
        tc, TConfig(**RIGID_CFG),
        tmpc.RigidWrenchControl(body_indices=(0,), max_force=120.0),
        planner="mppi", planner_cfg=tcfg, device="cpu",
        **_rigid_terms(tmpc))
    key = jax.random.PRNGKey(21)
    n_steps = 3
    noise = _controller_noise(key, n_steps, jcfg, jcfg.sigma, u_dim=6)
    fj, ij = jrun(key, js, n_steps)
    ft, it = trun(ts, n_steps, noise=torch.from_numpy(noise))
    assert it["controls"].shape == (n_steps, 6)
    # the executed controls are updates (~90 N here): 1e-3, the costs 1e-5
    assert np.abs(it["controls"].numpy()
                  - np.asarray(ij["controls"])).max() <= 1e-3
    assert _rel(it["cost"].numpy(), ij["cost"]) <= 1e-5
    assert np.abs(ft.rigid.x.numpy() - np.asarray(fj.rigid.x)).max() <= 1e-5
    assert ft.rigid.x.shape == (1, 3)


def test_mppi_avoids_sdf_obstacle_fed_jax_noise():
    """JAX's ``test_mppi_avoids_sdf_obstacle`` scene (``tests/test_mpc.py:
    51-87``): the free body, no gravity, a sphere obstacle of radius 0.25
    between it and the target, ``rigid_sdf_obstacle`` at weight 500, MPPI
    K 96, h 10, 2 updates a step; 10 controller steps fed the draws JAX's
    controller makes from its key. Costs 1e-5 relative, the body 1e-5; it
    stays out of the obstacle. The executed controls are updates: a cost
    rounding δ moves a weight by δ/λ (λ 0.05), and the obstacle's weight
    500 makes the costs large, so they are held to 1e-4 relative to the
    largest (~120 N)."""
    from positionbaseddynamics_tpu.collision.sdf import SDFShape as JShape
    from positionbaseddynamics_tpu_torch.collision.sdf import (
        SDFShape as TShape)

    js, jc, ts, tc = _free_rigid_scenes()
    cfg = dict(substeps=2, gravity=(0.0, 0.0, 0.0))
    target = np.array([1.2, 0.0, 0.0], np.float32)
    obstacle_pos = np.array([0.6, 0.0, 0.0], np.float32)
    pc = dict(horizon=10, num_samples=96, sigma=20.0, temperature=0.05,
              plan_iters=2)
    runs = {}
    for name, m, shape, conf in (("j", jmpc, JShape, JConfig),
                                 ("t", tmpc, TShape, TConfig)):
        kw = {} if name == "j" else {"device": "cpu"}
        runs[name] = m.make_mpc_controller(
            jc if name == "j" else tc, conf(**cfg),
            m.RigidWrenchControl(body_indices=(0,), max_force=120.0),
            running_cost=m.combine(
                m.as_running(m.rigid_target(0, target, weight=1.0)),
                m.rigid_sdf_obstacle([shape.sphere(0.25)], 0, radius=0.1,
                                     weight=500.0,
                                     translations=[obstacle_pos]),
                m.control_effort(1e-6)),
            terminal_cost=m.rigid_target(0, target, weight=10.0),
            planner="mppi", planner_cfg=m.MPPIConfig(**pc), **kw)
    key = jax.random.PRNGKey(1)
    n_steps = 10
    noise = _controller_noise(key, n_steps, jmpc.MPPIConfig(**pc), 20.0,
                              u_dim=6)
    fj, ij = jax.jit(lambda k, s: runs["j"](k, s, n_steps))(key, js)
    ft, it = runs["t"](ts, n_steps, noise=torch.from_numpy(noise))
    assert _rel(it["controls"].numpy(), ij["controls"]) <= 1e-4
    assert _rel(it["cost"].numpy(), ij["cost"]) <= 1e-5
    assert np.abs(ft.rigid.x.numpy() - np.asarray(fj.rigid.x)).max() <= 1e-5
    assert np.linalg.norm(ft.rigid.x.numpy()[0] - obstacle_pos) > 0.25
    assert np.linalg.norm(ft.rigid.x.numpy()[0]) > 0.05


def test_mpc_exports_the_jax_names():
    assert sorted(tmpc.__all__) == sorted(jmpc.__all__)
    for name in tmpc.__all__:
        assert callable(getattr(tmpc, name)), name
