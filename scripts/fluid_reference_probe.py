"""Reference-side facts of the fluid path, measured on the CPU with the JAX
package (and the PyTorch port where named).

    PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/fluid_reference_probe.py

Prints four things:

1. how far JAX's own two cell routes (occupancy classes and unpartitioned)
   and the port's cell route drift apart in ``dt`` and positions over 10
   steps of the 8×8×6 dam of ``tests/test_fluids.py``;
2. the ``bench.py --fluid`` dam's first 100 steps at the 16×10×6 cut in
   JAX: simulated time, max|v|, the mean height's change;
3. the Pallas route's XSPH pair set (rebuilt from the post-projection
   tables, ``model.py:329-332``) against the step's pre-projection one,
   on the 8×8×6 dam 20 steps in: pairs that differ, and the velocity
   difference XSPH makes of it;
4. the 12×10×8 dam of ``test_classgrid_matches_cellgrid`` started
   squeezed to 0.8 of its spacing (both occupancy classes in use): over
   15 steps, max|Δx| between JAX's two cell routes, between the port's
   two (``_fluid_step_cells(partition=True/False)``), and between each
   port route and its JAX counterpart.
"""
import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from positionbaseddynamics_tpu.fluids import cellgrid as cg  # noqa: E402
from positionbaseddynamics_tpu.fluids import model as jm  # noqa: E402

R, D = 0.025, 0.05


def dam_8x8x6():
    fluid = jm.block_positions((D, D, D), (8, 8, 6), D)
    hi = (10 * D * 3, 10 * D * 2, 8 * D)
    scene = jm.FluidScene.create(len(fluid), jm.box_boundary((0, 0, 0), hi, D),
                                 particle_radius=R, domain=((0, 0, 0), hi))
    return scene, fluid


def drift():
    from positionbaseddynamics_tpu_torch import convert
    from positionbaseddynamics_tpu_torch.fluids import model as tm

    js, fluid = dam_8x8x6()
    arrays = {k: np.asarray(getattr(js, k))
              for k in ("mass", "boundary_x", "boundary_psi")}
    g = js.cellgrid
    b = g.boundary
    scene = dict(arrays, **{k: getattr(js, k) for k in (
        "density0", "support_radius", "viscosity", "iterations",
        "cap_per_cell", "min_dt", "max_dt", "particle_radius", "gravity",
        "hash_cap")}, cellgrid=dict(
        origin=g.origin, dims=g.dims, cell=g.cell, cap=g.cap,
        max_active=g.max_active, boundary=dict(
            xt=[np.asarray(p) for p in b.xt], psit=np.asarray(b.psit),
            capb=b.capb, near=np.asarray(b.near), near_frac=b.near_frac)))
    ts = convert.fluid_scene_from_numpy(scene, device="cpu")
    fa = jm.make_fluid_step_fn(js)
    fb = jax.jit(lambda s: jm._fluid_step_cells(s, js, partition=False))
    ft = tm.make_fluid_step_fn(ts, device="cpu")
    a = b_ = jm.FluidState.create(fluid)
    t = tm.FluidState.create(fluid, device="cpu")
    worst = {"dt classes-cells": 0.0, "dt port-classes": 0.0,
             "x classes-cells": 0.0, "x port-classes": 0.0}
    for _ in range(10):
        a, b_, t = fa(a), fb(b_), ft(t)
        rel = lambda p, q: abs(float(p) - float(q)) / abs(float(q))
        worst["dt classes-cells"] = max(worst["dt classes-cells"],
                                        rel(a.dt, b_.dt))
        worst["dt port-classes"] = max(worst["dt port-classes"],
                                       rel(t.dt, a.dt))
        worst["x classes-cells"] = max(worst["x classes-cells"], float(
            np.abs(np.asarray(a.x) - np.asarray(b_.x)).max()))
        worst["x port-classes"] = max(worst["x port-classes"], float(
            np.abs(t.x.numpy() - np.asarray(a.x)).max()))
    print("1. 8x8x6 dam, worst over 10 steps (dt relative, x absolute):",
          worst)


def ejection():
    nx, ny, nz = dims = (16, 10, 6)
    fluid = jm.block_positions((D, D, D), dims, D)
    hi = ((nx + 2) * D * 4.0, (ny + 2) * D * 2.0, (nz + 2) * D)
    scene = jm.FluidScene.create(len(fluid), jm.box_boundary((0, 0, 0), hi, D),
                                 particle_radius=R, domain=((0, 0, 0), hi))
    fn = jm.make_fluid_step_fn(scene)
    s = jm.FluidState.create(fluid)
    vmax = 0.0
    for _ in range(100):
        s = fn(s)
        vmax = max(vmax, float(jnp.abs(s.v).max()))
    rise = float(np.asarray(s.x)[:, 1].mean() - fluid[:, 1].mean())
    print(f"2. bench dam cut {dims}, 100 steps: time {float(s.time)!r} s, "
          f"last dt {float(s.dt)!r}, max|v| {vmax!r} m/s, mean height "
          f"{rise:+.6f} m, overflow {float(s.overflow)}")


def pallas_xsph_pairs():
    scene, fluid = dam_8x8x6()
    spec = scene.cellgrid
    fn = jax.jit(lambda s: jm._fluid_step_cells(s, scene, partition=False))
    s = jm.FluidState.create(fluid)
    for _ in range(20):
        s = fn(s)
    a = jnp.broadcast_to(jnp.asarray(scene.gravity, jnp.float32), s.x.shape)
    h = jm.cfl_dt(s.v, a, s.dt, scene)
    v = s.v + h * a
    x = s.x + h * v
    slot, kept, xt, mt, active, nbr, nbr_ok, _ = cg.build_fluid_tables(
        spec, x, scene.mass)
    xt_new, dens, pre = cg.pbf_iterations(spec, xt, mt, active, nbr, nbr_ok,
                                          scene.iterations, scene.density0,
                                          scene.support_radius)
    _, _, post = cg.pbf_iterations(spec, xt_new, mt, active, nbr, nbr_ok, 0,
                                   scene.density0, scene.support_radius)
    x_new = jnp.stack([p.reshape(-1)[slot] for p in xt_new], -1)
    v = jnp.where(kept[:, None], (x_new - s.x) / h, v)
    nslots = spec.n_cells * spec.cap
    vt = tuple(jnp.zeros((nslots,), jnp.float32).at[
        jnp.where(kept, slot, nslots)].set(v[:, c], mode="drop").reshape(
        spec.n_cells, spec.cap) for c in range(3))
    out = [cg.xsph_cell(spec, xt_new, vt, mt, active, nbr, nbr_ok, dens,
                        scene.viscosity, scene.support_radius, m)
           for m in (pre, post)]
    dv = max(float(jnp.abs(p - q).max()) for p, q in zip(*out))
    print(f"3. 8x8x6 dam, 20 steps in: {int(jnp.sum(pre))} pre-projection "
          f"pairs, {int(jnp.sum(pre != post))} differ after the projection; "
          f"XSPH velocities differ by {dv!r}")


def _port_scene(js):
    from positionbaseddynamics_tpu_torch import convert

    g, b = js.cellgrid, js.cellgrid.boundary
    return convert.fluid_scene_from_numpy(dict(
        {k: np.asarray(getattr(js, k))
         for k in ("mass", "boundary_x", "boundary_psi")},
        **{k: getattr(js, k) for k in (
            "density0", "support_radius", "viscosity", "iterations",
            "cap_per_cell", "min_dt", "max_dt", "particle_radius", "gravity",
            "hash_cap")}, cellgrid=dict(
            origin=g.origin, dims=g.dims, cell=g.cell, cap=g.cap,
            max_active=g.max_active, boundary=dict(
                xt=[np.asarray(p) for p in b.xt], psit=np.asarray(b.psit),
                capb=b.capb, near=np.asarray(b.near),
                near_frac=b.near_frac))), device="cpu")


def squeezed_routes():
    from positionbaseddynamics_tpu_torch.fluids import model as tm

    fluid = jm.block_positions((D, D, D), (12, 10, 8), D)
    hi = (1.4, 1.1, 0.5)
    js = jm.FluidScene.create(len(fluid), jm.box_boundary((0, 0, 0), hi, D),
                              particle_radius=R, domain=((0, 0, 0), hi))
    ts = _port_scene(js)
    x0 = (D + 0.8 * (fluid - D)).astype(np.float32)
    jf = {p: jax.jit(lambda s, p=p: jm._fluid_step_cells(s, js, partition=p))
          for p in (True, False)}
    j = {p: jm.FluidState.create(x0) for p in (True, False)}
    t = {p: tm.FluidState.create(x0, device="cpu") for p in (True, False)}
    for step in range(15):
        for p in (True, False):
            j[p] = jf[p](j[p])
            t[p] = tm._fluid_step_cells(t[p], ts, partition=p)
        jx = {p: np.asarray(j[p].x) for p in j}
        tx = {p: t[p].x.numpy() for p in t}
        print(f"4. squeezed 12x10x8 dam, step {step + 1}: JAX classes-cells "
              f"{np.abs(jx[True] - jx[False]).max():.3e}, port classes-cells "
              f"{np.abs(tx[True] - tx[False]).max():.3e}, classes port-JAX "
              f"{np.abs(tx[True] - jx[True]).max():.3e}, cells port-JAX "
              f"{np.abs(tx[False] - jx[False]).max():.3e}, dt "
              f"{float(j[True].dt)!r}")


if __name__ == "__main__":
    drift()
    ejection()
    pallas_xsph_pairs()
    squeezed_routes()
