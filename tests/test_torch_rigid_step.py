"""The port's rigid route (``solver/step.py``'s ``torch_rigid``: rigid
integration, the joint pass after the particle families, the velocity
motors' pass) against the JAX package's jitted step, on the CPU.

Scenes (``torch_rigid_scenes``) are built by each package's
``SceneBuilder`` from the same arguments: ``examples/chain_demo.py``'s
chain, ``joint_demo.py``'s nine pairs, ``sbt_demo.py``'s rod,
``coupling_demo.py``'s link and cloth, a damper / distance / spring scene
(the kinds no example uses), and JAX's ``test_rigid_free_fall_and_spin``
body, each run at the examples' ``StepConfig(max_iterations=5)``.

Tolerances (ROADMAP §C): positions and rotations 1e-5 over 20 steps; a
velocity or ω is a difference over the substep ``h``, held to 2 × the
position bar / h. Three scenes are more sensitive than that in the
reference itself, and take 1e-4: three of the joint demo's pendulums, which
sit at y 2–6, where connector differences cancel to an ulp of the
coordinates and the swing carries it, and the damper / distance / spring
scene, whose spinning rigid-distance pendulum keeps a velocity off by a
rounding. Each such test also checks that JAX given one float32 step of
noise in x after every step (:func:`_ulp_spread`) parts from itself by
more than 1e-5. Jacobi joints on a chain break down in
the reference itself (the corrections of a link's two joints add without
averaging), so that chain is compared over the 3 steps before it parts,
and a probe shows the parting is JAX's own.

The port runs single-threaded here: PyTorch's threaded CPU LU takes
milliseconds on a handful of 6×6 systems."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rigid_scenes as scenes
from positionbaseddynamics_tpu.models import SceneBuilder as JBuilder
from positionbaseddynamics_tpu.solver import StepConfig as JConfig
from positionbaseddynamics_tpu.solver.step import step as jstep
from positionbaseddynamics_tpu_torch import convert
from positionbaseddynamics_tpu_torch.models import SceneBuilder as TBuilder
from positionbaseddynamics_tpu_torch.solver import StepConfig as TConfig
from positionbaseddynamics_tpu_torch.solver import make_step_fn
from positionbaseddynamics_tpu_torch.solver import rollout as trollout
from positionbaseddynamics_tpu_torch.solver.constraints import ConstraintSet
from positionbaseddynamics_tpu_torch.solver.state import SimState

POS_ATOL = 1e-5
MAX_BAR = 1e-4
N_STEPS = 20
DEMO = dict(max_iterations=5)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_steps(js, jc, cfg, counts):
    """JAX's jitted step from ``js``: the states after each step count in
    ``counts``, one compile for all."""
    f = jax.jit(lambda s: jstep(s, jc, cfg))
    out, s = {}, js
    for i in range(1, max(counts) + 1):
        s = f(s)
        if i in counts:
            out[i] = s
    return out, f


def _nudge(s, sign):
    """``s`` with every dynamic body's x one float32 step toward
    ``sign``·∞."""
    r = s.rigid
    x = np.asarray(r.x).copy()
    dyn = np.asarray(r.inv_mass) > 0
    x[..., dyn, :] = np.nextafter(x[..., dyn, :], np.float32(sign * np.inf))
    return dataclasses.replace(s, rigid=dataclasses.replace(
        r, x=jnp.asarray(x)))


def _ulp_spread(js, f, n):
    """The scene's float32 sensitivity in the reference itself: JAX against
    JAX whose dynamic bodies take one float32 step of noise in x after
    every step, as another rounding order adds — once with the sign
    alternating, once always the same (a bias); the larger of the two
    largest position differences after ``n`` steps."""
    out = []
    for sign in ((lambda i: (-1) ** i), (lambda i: 1)):
        a, b = js, js
        for i in range(n):
            a, b = f(a), _nudge(f(b), sign(i))
        out.append(float(np.abs(np.asarray(a.rigid.x)
                                - np.asarray(b.rigid.x)).max()))
    return max(out)


def _diff(t, j):
    t = t.numpy()
    return float(np.abs(t - np.asarray(j)).max()) if t.size else 0.0


def _assert_close(ts, js, h, atol):
    for f in ("x", "q", "old_x", "last_x", "old_q", "last_q"):
        assert _diff(getattr(ts.rigid, f), getattr(js.rigid, f)) <= atol, f
    for f in ("v", "omega"):
        assert _diff(getattr(ts.rigid, f), getattr(js.rigid, f)) \
            <= 2 * atol / h, f
    assert _diff(ts.particles.x, js.particles.x) <= atol
    assert _diff(ts.particles.v, js.particles.v) <= 2 * atol / h
    np.testing.assert_allclose(ts.time.numpy(), np.asarray(js.time),
                               atol=1e-7)


def _compare(scene, overrides=None, n_steps=N_STEPS, atol=POS_ATOL,
             moved=1e-4):
    """Build with both packages, step both ``n_steps``, compare to
    ``atol``. A bar above ``POS_ATOL`` is the reference's own: the test
    then also checks that JAX given float32 noise (:func:`_ulp_spread`)
    parts from itself by more than ``POS_ATOL``. ``moved``: the least
    motion of some body or particle (None: the scene may stand still).
    Returns the port's start and end states."""
    kw = dict(DEMO, **(overrides or {}))
    js, jc = scene(JBuilder)
    ts, tc = scene(TBuilder, device="cpu")
    assert make_step_fn(tc, TConfig(**kw), device="cpu").path == \
        "torch_rigid"
    out, f = _jax_steps(js, jc, JConfig(**kw), {n_steps})
    tfin, _ = trollout(ts, tc, TConfig(**kw), n_steps)
    if atol > POS_ATOL:
        spread = _ulp_spread(js, f, n_steps)
        print(f"{scene.__name__} {kw}: JAX's float32-noise spread "
              f"{spread!r}, port {_diff(tfin.rigid.x, out[n_steps].rigid.x)!r}"
              f", bar {atol!r}")
        assert spread > POS_ATOL
    h = kw.get("dt", 0.005) / kw.get("substeps", 5)
    _assert_close(tfin, out[n_steps], h, atol)
    # static bodies stay exactly where they were
    static = ts.rigid.inv_mass == 0
    assert torch.equal(tfin.rigid.x[static], ts.rigid.x[static])
    if moved is not None:
        motion = max((tfin.rigid.x - ts.rigid.x).abs().max(),
                     (tfin.particles.x - ts.particles.x).abs().max()
                     if ts.particles.n else 0.0)
        assert motion > moved
    return ts, tfin


def test_chain_gauss_seidel_matches_jax():
    _, fin = _compare(scenes.chain)
    gaps = (fin.rigid.x[1:] - fin.rigid.x[:-1]).norm(dim=-1)
    assert (gaps - 1.0).abs().max() < 1e-2        # the links stay joined


def test_chain_jacobi_matches_jax_before_the_references_breakdown():
    _compare(scenes.chain, dict(joint_solver_mode="jacobi"), n_steps=3)


def test_jacobi_chain_breakdown_is_the_references_own():
    """The probe behind the 3 steps above: by step 10 JAX's own run given
    one float32 step of noise a step is centimetres off, and the port is
    no farther from JAX than that spread allows."""
    kw = dict(DEMO, joint_solver_mode="jacobi")
    js, jc = scenes.chain(JBuilder)
    ts, tc = scenes.chain(TBuilder, device="cpu")
    out, f = _jax_steps(js, jc, JConfig(**kw), {10})
    spread = _ulp_spread(js, f, 10)
    port = trollout(ts, tc, TConfig(**kw), 10)[0]
    dev = _diff(port.rigid.x, out[10].rigid.x)
    print(f"jacobi chain, 10 steps: JAX's float32-noise spread {spread!r}, port "
          f"{dev!r}")
    assert spread > 1e-2
    assert dev <= 3.0 * spread


#: The joint demo's pairs whose trajectory the reference does not define to
#: 1e-5 in float32 (ROADMAP §C): pendulums at y 2–6, where connector
#: differences cancel to an ulp of the coordinates and the swing carries it.
PAIR_BAR = {"ball_on_line": MAX_BAR, "hinge": MAX_BAR, "universal": MAX_BAR}


@pytest.mark.parametrize("kind", scenes.JOINT_DEMO_NAMES)
def test_joint_demo_pair_matches_jax(kind):
    """One pair of ``examples/joint_demo.py`` at its place in the demo."""
    def pair(builder, **kw):
        return scenes.joint_demo(builder, only=kind, **kw)

    pair.__name__ = f"joint_demo pair {kind}"
    # a slider across gravity does not move
    _compare(pair, atol=PAIR_BAR.get(kind, POS_ATOL),
             moved=None if kind == "slider" else 1e-4)


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["gauss_seidel", "jacobi"])
def test_joint_demo_matches_jax(mode):
    """The whole demo in one scene (JAX compiles its nine batches × five
    iterations for ~30 s, hence slow); the pairs are independent, so
    Jacobi and Gauss-Seidel agree."""
    _compare(scenes.joint_demo, dict(joint_solver_mode=mode), atol=MAX_BAR)


def test_sbt_rod_matches_jax():
    _compare(scenes.sbt)


def test_coupling_scene_matches_jax():
    ts, fin = _compare(scenes.coupling)
    # the hung cloth corners follow the link's connectors
    assert fin.particles.x[0, 1] < ts.particles.x[0, 1]


@pytest.mark.parametrize("mode", ["gauss_seidel", "jacobi"])
def test_damper_distance_and_spring_scene_matches_jax(mode):
    """The rigid distance joint is a spinning pendulum: a velocity off by a
    rounding persists, so the port drifts from JAX as JAX drifts from itself
    under a float32 bias (ROADMAP §C); bar 1e-4."""
    _compare(scenes.springs, dict(joint_solver_mode=mode), atol=MAX_BAR)


def test_free_body_matches_jax_and_falls_and_spins():
    """JAX's ``test_rigid_free_fall_and_spin`` body: 20 steps against JAX,
    then its own checks over 50 steps (ballistic fall, |ω| kept)."""
    _compare(scenes.free_body, {})
    ts, _ = scenes.free_body(TBuilder, device="cpu")
    fin, _ = trollout(ts, ConstraintSet(n_particles=0, n_rigid=1),
                      TConfig(), 50)
    t = 50 * TConfig().dt
    assert abs(float(fin.rigid.x[0, 1]) + 0.5 * 9.81 * t * t) < 1e-2
    assert abs(float(fin.rigid.omega[0].norm()) - 3.0) < 1e-3


def _jax_arrays(js, jc):
    state = {k: np.asarray(getattr(js.particles, k))
             for k in ("x", "v", "old_x", "last_x", "x0", "inv_mass")}
    state["time"] = np.asarray(js.time)
    state["overflow"] = np.asarray(js.overflow)
    rigid = {f.name: np.asarray(getattr(js.rigid, f.name))
             for f in dataclasses.fields(js.rigid)}
    joints = []
    for jb in jc.joints:
        arrays = {f.name: np.asarray(getattr(jb, f.name))
                  for f in dataclasses.fields(jb)
                  if not f.metadata.get("static")
                  and getattr(jb, f.name) is not None}
        joints.append((arrays, {"kind": jb.kind,
                                "num_colors": jb.num_colors}))
    return state, rigid, joints


def test_scene_from_numpy_continues_a_jax_rigid_scene():
    """A JAX-built damper / distance / spring scene, 5 steps in JAX, carried
    across with ``convert.scene_from_numpy(rigid=, joints=)``: 5 more port
    steps equal 5 more JAX steps."""
    js, jc = scenes.springs(JBuilder)
    cfg = dict(DEMO)
    out, f = _jax_steps(js, jc, JConfig(**cfg), {5, 10})
    state, rigid, joints = _jax_arrays(out[5], jc)
    ts, tc = convert.scene_from_numpy(state, [], [], device="cpu",
                                      rigid=rigid, joints=joints)
    assert tc.n_rigid == 4 and [j.kind for j in tc.joints] == \
        [j.kind for j in jc.joints]
    fin, _ = trollout(ts, tc, TConfig(**cfg), 5)
    _assert_close(fin, out[10], 0.001, POS_ATOL)


def test_k_rollouts_equal_each_rollout_alone():
    """A state of K rollouts (rigid fields ``(K, R, ...)``, ``inv_mass`` and
    ``inertia0`` shared, different pushes) steps each rollout as alone, in
    both joint modes and with a cloth coupled in."""
    for scene, mode in ((scenes.chain, "gauss_seidel"),
                        (scenes.coupling, "jacobi")):
        ts, tc = scene(TBuilder, device="cpu")
        cfg = TConfig(max_iterations=2, joint_solver_mode=mode)
        r = ts.rigid
        rng = np.random.default_rng(0)
        pushes = torch.from_numpy(
            rng.normal(0.0, 3.0, (3,) + tuple(r.x.shape)).astype(np.float32))
        singles = [dataclasses.replace(ts, rigid=dataclasses.replace(
            r, ext_force=pushes[k])) for k in range(3)]
        per = ("x", "v", "q", "omega", "old_x", "last_x", "old_q", "last_q",
               "ext_force", "ext_torque")
        batched = dataclasses.replace(
            ts,
            rigid=dataclasses.replace(r, **{
                f: torch.stack([getattr(s.rigid, f) for s in singles])
                for f in per}),
            particles=dataclasses.replace(ts.particles, **{
                f: torch.stack([getattr(ts.particles, f)] * 3)
                for f in ("x", "v", "old_x", "last_x")}))
        out = trollout(batched, tc, cfg, 3)[0]
        for k, s in enumerate(singles):
            alone = trollout(s, tc, cfg, 3)[0]
            for f in ("x", "q", "v", "omega"):
                np.testing.assert_allclose(
                    getattr(out.rigid, f)[k].numpy(),
                    getattr(alone.rigid, f).numpy(), atol=1e-6, rtol=0,
                    err_msg=f)
            np.testing.assert_allclose(out.particles.x[k].numpy(),
                                       alone.particles.x.numpy(), atol=1e-6,
                                       rtol=0)


def test_reset_restores_the_rigid_start():
    ts, tc = scenes.springs(TBuilder, device="cpu")
    fin, _ = trollout(ts, tc, TConfig(), 3)
    back = fin.reset()
    for f in ("x", "q", "old_x", "last_x", "old_q", "last_q"):
        start = ts.rigid.x0 if "x" in f else ts.rigid.q0
        assert torch.equal(getattr(back.rigid, f), start), f
    for f in ("v", "omega", "ext_force", "ext_torque"):
        assert not getattr(back.rigid, f).any(), f
    assert float(back.time) == 0.0


def test_rigid_entry_points_need_cuda_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = TBuilder()
    b.add_rigid_body((0.0, 0.0, 0.0), mass=0.0)
    b.add_rigid_body((1.0, 0.0, 0.0))
    b.add_ball_joint(0, 1, (0.5, 0.0, 0.0))
    with pytest.raises(RuntimeError, match="CUDA"):
        b.build()
    ts, tc = b.build(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_step_fn(tc, TConfig())


def test_unported_rigid_branches_raise_naming_their_slice():
    """The rod branches raise naming slice 7. A collision pipeline (ported
    with collision) that holds no pair steps the chain as no pipeline
    does, through ``make_step_fn`` and ``rollout``."""
    from positionbaseddynamics_tpu_torch.collision import CollisionPipeline

    ts, tc = scenes.chain(TBuilder, device="cpu")
    idle = CollisionPipeline.create()
    assert not idle.active
    plain = make_step_fn(tc, TConfig(), device="cpu")(ts)
    for s in (make_step_fn(tc, TConfig(), device="cpu", pipeline=idle)(ts),
              trollout(ts, tc, TConfig(), 1, pipeline=idle)[0]):
        assert torch.equal(s.rigid.x, plain.rigid.x)
        assert torch.equal(s.overflow, plain.overflow)
    for field in ("direct_rods", "rigid_generics"):
        with pytest.raises(NotImplementedError, match="slice 7"):
            ConstraintSet(**{field: (object(),)})
    with pytest.raises(NotImplementedError, match=r"slice \(7\)"):
        SimState.create(ts.particles, orientations=object())
