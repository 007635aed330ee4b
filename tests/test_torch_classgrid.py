"""The port's occupancy-class route (``fluids/classgrid.py`` behind
``_fluid_step_cells(partition=True)``) against the JAX package's, on the
CPU.

Tolerances: the class lists, their neighbour tables and the overflow
exactly (the same packed int32 keys, sorted); the step within 1e-4
max|Δx| over 10 steps, the JAX package's own bar between its class route
and its unpartitioned cell route (``test_classgrid_matches_cellgrid``),
with ``dt`` and ``time`` held as ``tests/test_torch_fluid_step.py`` holds
them (1e-6 relative after the first step, 1e-4 at step 10), and the
positions after the first step within 1e-6 from the dam at rest (1e-4
from the squeezed dam, whose first projection moves particles by
centimetres); the port's class route against its own unpartitioned route
by the same 1e-4 over 15 steps, on JAX's inputs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from positionbaseddynamics_tpu.fluids import cellgrid as jcg
from positionbaseddynamics_tpu.fluids import classgrid as jcl
from positionbaseddynamics_tpu.fluids import model as jm
from positionbaseddynamics_tpu_torch import convert
from positionbaseddynamics_tpu_torch.fluids import cellgrid as tcg
from positionbaseddynamics_tpu_torch.fluids import classgrid as tcl
from positionbaseddynamics_tpu_torch.fluids import model as tm
from test_torch_fluid_cells import scene_numpy

R = 0.025
D = 2 * R
BLOCK, HI = (12, 10, 8), (1.4, 1.1, 0.5)     # test_classgrid_matches_cellgrid


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch thread: the class passes are large elementwise ops, and
    under the suite's parallel workers each process's pool oversubscribes
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scenes(max_active=None):
    fluid = tm.block_positions((D, D, D), BLOCK, D)
    bnd = tm.box_boundary((0.0, 0.0, 0.0), HI, D)
    js = jm.FluidScene.create(len(fluid), bnd, particle_radius=R,
                              domain=((0, 0, 0), HI))
    assert js.cellgrid.cap > 20 and jm.use_classes(js.cellgrid)
    if max_active is not None:
        js = dataclasses.replace(js, cellgrid=dataclasses.replace(
            js.cellgrid, max_active=max_active))
    ts = convert.fluid_scene_from_numpy(scene_numpy(js), device="cpu")
    return fluid, js, ts


def _mixed_positions(rng):
    """A block squeezed to 0.7 of its spacing on the floor (cells of ~23
    particles: the full class), the bench block's spacing beside it (the
    narrow class), and 900 particles strewn over the box (hundreds of
    sparse cells, many beside the walls)."""
    dense = tm.block_positions((0.06, 0.06, 0.06), (10, 8, 6), 0.7 * D)
    rest = tm.block_positions((0.6, 0.06, 0.06), (8, 6, 6), D)
    strewn = rng.uniform((0.03, 0.03, 0.03), np.asarray(HI) - 0.03,
                         (900, 3))
    return np.concatenate([dense, rest, strewn]).astype(np.float32)


def _lists_equal(t, j):
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("max_active", [None, 120])
def test_partition_active_equals_jax(max_active):
    """The lists, neighbour tables and overflow of both classes and both
    boundary lists, exactly. At ``max_active`` 120 the narrow lists (120)
    spill into the full lists (256) and those drop cells, which the
    overflow counts."""
    fluid, js, ts = _scenes(max_active)
    x = _mixed_positions(np.random.default_rng(0))
    mass = np.full(len(x), float(js.mass[0]), np.float32)
    jt = jcg.build_fluid_tables(js.cellgrid, jnp.asarray(x),
                                jnp.asarray(mass))
    tt = tcg.build_fluid_tables(ts.cellgrid, torch.tensor(x),
                                torch.tensor(mass))
    np.testing.assert_array_equal(tt[3].numpy(), np.asarray(jt[3]))
    jn, jf, jb, jover = jcl.partition_active(js.cellgrid, jt[3])
    tn, tf, tb, tover = tcl.partition_active(ts.cellgrid, tt[3])
    _lists_equal(tn, jn)
    _lists_equal(tf, jf)
    assert jb is not None and tb is not None
    for t, j in zip(tb, jb):
        _lists_equal(t, j)
    assert int(tover) == int(jover)
    np.testing.assert_array_equal(
        tcl._nbhd_max_occ(ts.cellgrid, tt[3]).numpy(),
        np.asarray(jcl._nbhd_max_occ(js.cellgrid, jt[3])))
    n_narrow, n_full = int(tn[1].sum()), int(tf[1].sum())
    assert n_narrow > 0 and n_full > 0
    if max_active is None:
        assert int(tover) == 0
    else:
        assert n_narrow == max_active and n_full == tf[0].shape[0] == 256
        assert int(tover) > 0 and int(tb[0][1].sum()) == max_active
    assert tcl.class_capacities(ts.cellgrid) == jcl.class_capacities(
        js.cellgrid)
    assert tcl.narrow_cap(ts.cellgrid) == jcl.narrow_cap(js.cellgrid) == 16


def _run(fn, state, n):
    for _ in range(n):
        state = fn(state)
    return state


def _assert_same(t, j, tol, dt_rtol):
    x = t.x.numpy()
    assert np.isfinite(x).all()
    assert np.abs(x - np.asarray(j.x)).max() <= tol
    for f in ("dt", "time"):
        a, b = float(getattr(t, f)), float(getattr(j, f))
        assert abs(a - b) <= dt_rtol * abs(b), f
    assert t.overflow.item() == 0.0 and float(j.overflow) == 0.0


def _start(name, fluid):
    """The dam at rest, as ``test_classgrid_matches_cellgrid`` starts it
    (its cells hold 8 particles: the narrow class), or squeezed to 0.8 of
    its spacing on the floor (27 in its fullest cells: both classes)."""
    return fluid if name == "rest" else (D + 0.8 * (fluid - D)).astype(
        np.float32)


def _uses_both_classes(ts, x):
    mt = tcg.build_fluid_tables(ts.cellgrid, torch.tensor(x), ts.mass)[3]
    narrow, full, _, _ = tcl.partition_active(ts.cellgrid, mt)
    return bool(narrow[1].any()) and bool(full[1].any())


@pytest.mark.parametrize("start", ["rest", "squeezed"])
def test_class_route_matches_jax_over_ten_steps(start):
    fluid, js, ts = _scenes()
    x0 = _start(start, fluid)
    assert _uses_both_classes(ts, x0) == (start == "squeezed")
    jfn = jax.jit(lambda s: jm._fluid_step_cells(s, js, partition=True))

    def tfn(s):
        return tm._fluid_step_cells(s, ts, partition=True)

    t1 = tfn(tm.FluidState.create(x0, device="cpu"))
    j1 = jfn(jm.FluidState.create(x0))
    _assert_same(t1, j1, 1e-6 if start == "rest" else 1e-4, 1e-6)
    t = _run(tfn, t1, 9)
    j = _run(jfn, j1, 9)
    _assert_same(t, j, 1e-4, 1e-4)
    # the dam collapsed: it spread sideways
    assert t.x[:, 0].max().item() > x0[:, 0].max() + 0.1 * D


def test_class_route_matches_the_unpartitioned_route():
    """JAX's own bar between its two routes, on the port, with its inputs:
    the dam at rest, 15 steps."""
    fluid, _, ts = _scenes()
    a = b = tm.FluidState.create(fluid, device="cpu")
    for _ in range(15):
        a = tm._fluid_step_cells(a, ts, partition=True)
        b = tm._fluid_step_cells(b, ts, partition=False)
    assert (a.x - b.x).abs().max().item() <= 1e-4
    assert a.overflow.item() == 0.0 and torch.isfinite(a.x).all()
