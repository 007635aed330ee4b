"""The port's direct stiff-rod solvers (``solver/direct_rods.py``) against
the JAX package's, on the CPU, after JAX's ``tests/test_stiff_rods.py``:
the chain of ``examples/stiff_rods_demo.py`` (block Thomas), its Y-tree
(dense and scheduled) and a random tree of ``bench.py --tree``'s
construction, built by both packages' ``SceneBuilder`` and run 20 steps
at ``StepConfig()``.

Tolerances: the build fields (computed in float64 numpy by both) and the
elimination schedule are equal. Positions 1e-5 over 20 steps. The stiff
systems (α of 1e-10/h² on the stretch rows) carry float32 rounding into
the rotations: JAX given one float32 step of noise in x after every step
parts from itself in q by 2.5e-5 on the Y-tree and in x by 1.5e-5 on the
30-segment tree (ROADMAP §C), so the trees' rotations, and the random
tree's positions, are held to 1e-4 with that spread asserted above 1e-5
(:func:`_ulp_spread`). The scheduled elimination against the dense solve
on the random tree: 2e-4 over 40 steps, JAX's own bar
(``tests/test_stiff_rods.py:357-358``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rod_scenes as scenes
from positionbaseddynamics_tpu.solver import StepConfig as JConfig
from positionbaseddynamics_tpu.solver import direct_rods as jdr
from positionbaseddynamics_tpu.solver import rollout as jrollout
from positionbaseddynamics_tpu.solver.step import step as jstep
from positionbaseddynamics_tpu_torch.solver import StepConfig as TConfig
from positionbaseddynamics_tpu_torch.solver import direct_rods as tdr
from positionbaseddynamics_tpu_torch.solver import make_step_fn
from positionbaseddynamics_tpu_torch.solver import rollout as trollout

ATOL = 1e-5
MAX_BAR = 1e-4
N_STEPS = 20


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _diff(t, j):
    return float(np.abs(t.numpy() - np.asarray(j)).max())


def _with_solver(cset, solver):
    if solver is None:
        return cset
    db = cset.direct_rods[0]
    return dataclasses.replace(cset, direct_rods=(
        dataclasses.replace(db, solver=solver),))


def _nudge(s, sign):
    r = s.rigid
    x = np.asarray(r.x).copy()
    dyn = np.asarray(r.inv_mass) > 0
    x[dyn] = np.nextafter(x[dyn], np.float32(sign * np.inf))
    return dataclasses.replace(s, rigid=dataclasses.replace(
        r, x=jnp.asarray(x)))


def _ulp_spread(js, jc, n):
    """JAX against JAX given one float32 step of noise in the bodies' x
    after every step (the sign alternating, or always +): the largest
    differences in x and in q after ``n`` steps."""
    f = jax.jit(lambda s: jstep(s, jc, JConfig()))
    dx = dq = 0.0
    for sign in ((lambda i: (-1) ** i), (lambda i: 1)):
        a = b = js
        for i in range(n):
            a, b = f(a), _nudge(f(b), sign(i))
        dx = max(dx, float(np.abs(np.asarray(a.rigid.x)
                                  - np.asarray(b.rigid.x)).max()))
        dq = max(dq, float(np.abs(np.asarray(a.rigid.q)
                                  - np.asarray(b.rigid.q)).max()))
    return dx, dq


def _compare(scene, solver=None, x_bar=ATOL, q_bar=ATOL, n_steps=N_STEPS):
    js, jc = scene("jax")
    ts, tc = scene("torch")
    jc, tc = _with_solver(jc, solver), _with_solver(tc, solver)
    assert make_step_fn(tc, TConfig(), device="cpu").path == "torch_rigid"
    jfin, _ = jax.jit(lambda s: jrollout(s, jc, JConfig(), n_steps))(js)
    tfin, _ = trollout(ts, tc, TConfig(), n_steps)
    dx, dq = _diff(tfin.rigid.x, jfin.rigid.x), _diff(tfin.rigid.q,
                                                      jfin.rigid.q)
    if max(x_bar, q_bar) > ATOL:
        sx, sq = _ulp_spread(js, jc, n_steps)
        print(f"{scene.__name__} {solver}: JAX's float32-noise spread x "
              f"{sx!r} q {sq!r}; port x {dx!r} q {dq!r}")
        if x_bar > ATOL:
            assert sx > ATOL
        if q_bar > ATOL:
            assert sq > ATOL
    assert dx <= x_bar and dq <= q_bar, (dx, dq)
    h = TConfig().dt / TConfig().substeps
    assert _diff(tfin.rigid.v, jfin.rigid.v) <= 2 * x_bar / h
    root = ts.rigid.inv_mass == 0
    assert torch.equal(tfin.rigid.x[root], ts.rigid.x[root])
    assert (tfin.rigid.x - ts.rigid.x).abs().max().item() > 1e-3
    return tc, tfin


@pytest.mark.parametrize("scene", [scenes.stiff_chain, scenes.y_tree,
                                   scenes.random_tree],
                         ids=["chain", "y_tree", "random_tree"])
def test_build_matches_jax(scene):
    """Every field of the stiff-rod batch, the tree's schedule with its
    statics included, equal to JAX's."""
    _, jc = scene("jax")
    _, tc = scene("torch")
    jb, tb = jc.direct_rods[0], tc.direct_rods[0]
    assert type(jb).__name__ == type(tb).__name__
    for f in dataclasses.fields(jb):
        a, b = getattr(tb, f.name), getattr(jb, f.name)
        if f.name == "schedule":
            assert sorted(a) == sorted(b)
            for k in b:
                np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]),
                                              err_msg=k)
        elif f.metadata.get("static"):
            assert a == b, f.name
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f.name)


@pytest.mark.parametrize("n_seg,seed", [(4, None), (31, 3), (101, 0)])
def test_tree_schedule_equals_jax(n_seg, seed):
    """``_build_tree_schedule`` of the Y-tree, a 30-constraint and
    ``bench.py --tree``'s 100-constraint random tree, array for array;
    and the levels: no two steps of a level conflict, and conflicting
    steps keep the schedule's order."""
    if seed is None:
        edges = np.array([(0, 1), (1, 2), (1, 3)], np.int32)
    else:
        edges = np.asarray(scenes.tree_geometry(n_seg, seed)[3], np.int32)
    want = jdr._build_tree_schedule(edges, n_seg)
    got = tdr._build_tree_schedule(edges, n_seg)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                      err_msg=k)
    level = tdr.schedule_levels(got)
    later = [set(a for a in row if a >= 0) for row in got["nbr_idx"]]
    for k in range(len(level)):
        for kk in range(k):
            if got["piv"][k] in later[kk] or later[k] & later[kk]:
                assert level[kk] < level[k]
    if n_seg == 101:
        print(f"bench tree: {len(level)} pivots in {level.max() + 1} levels")
        assert level.max() + 1 < len(level) // 2


def test_chain_matches_jax():
    """The block-Thomas chain: positions and rotations 1e-5."""
    _, fin = _compare(scenes.stiff_chain)
    gaps = (fin.rigid.x[1:] - fin.rigid.x[:-1]).norm(dim=-1)
    assert (gaps - 0.5).abs().max().item() < 0.12


@pytest.mark.parametrize("solver", ["dense", "tree"])
def test_y_tree_matches_jax(solver):
    tc, fin = _compare(scenes.y_tree, solver, q_bar=MAX_BAR)
    assert tc.direct_rods[0].uses_tree == (solver == "tree")
    start = scenes.y_tree("torch")[0].rigid.x
    assert (fin.rigid.x[2:, 1] < start[2:, 1] - 0.002).all()  # both fall


def test_random_tree_matches_jax_and_scheduled_matches_dense():
    """The 30-constraint random tree, scheduled, against JAX's (1e-4, the
    spread asserted), then the port's scheduled elimination against its
    dense solve over 40 steps (2e-4)."""
    _compare(scenes.random_tree, "tree", x_bar=MAX_BAR, q_bar=MAX_BAR)
    fins = {}
    for solver in ("dense", "tree"):
        ts, tc = scenes.random_tree("torch", solver=solver)
        fins[solver] = trollout(ts, tc, TConfig(), 40)[0].rigid.x
    assert torch.isfinite(fins["tree"]).all()
    assert (fins["tree"] - fins["dense"]).abs().max().item() < 2e-4


@pytest.mark.parametrize("scene,solver", [(scenes.stiff_chain, None),
                                          (scenes.random_tree, "tree")],
                         ids=["chain", "random_tree"])
def test_rollouts_match_themselves_alone(scene, solver):
    """K = 2 rollouts (the second's bodies jittered) on a leading axis,
    each against itself alone over 5 steps, ≤ 1e-6."""
    ts, tc = scene("torch")
    tc = _with_solver(tc, solver)
    fn = make_step_fn(tc, TConfig(), device="cpu")
    r = ts.rigid
    rng = np.random.default_rng(9)
    dyn = (r.inv_mass > 0)[:, None]
    x2 = r.x + torch.where(dyn, torch.from_numpy(rng.normal(
        0.0, 1e-3, tuple(r.x.shape)).astype(np.float32)), 0.0)
    batched = dataclasses.replace(ts, rigid=dataclasses.replace(r, **{
        f: torch.stack([getattr(r, f), x2 if f == "x" else getattr(r, f)])
        for f in ("x", "v", "q", "omega", "old_x", "last_x", "old_q",
                  "last_q", "ext_force", "ext_torque")}))
    alone = [ts, dataclasses.replace(ts, rigid=dataclasses.replace(
        r, x=x2))]
    for _ in range(5):
        batched = fn(batched)
        alone = [fn(a) for a in alone]
    for k in range(2):
        assert (batched.rigid.x[k] - alone[k].rigid.x).abs().max() <= 1e-6
        assert (batched.rigid.q[k] - alone[k].rigid.q).abs().max() <= 1e-6
