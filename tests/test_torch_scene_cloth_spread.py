"""How far the ClothOnBunny stand-in (``bench_torch.write_cloth_scene``,
51×51) parts from itself in float32, in JAX itself: the loaded scene's
jitted step against the same step whose free particles take one float32
step of noise in x after every step, as another rounding order adds (the
pendulums' witness in ``test_torch_rigid_step.py``). The largest position
difference after ``STEPS`` steps is the scene's own float32 spread.

With the loader's default cloth methods (FEM triangles, classic isometric
bending) the spread passes 1e-4 within the 20 steps that the card is held
to the CPU over, so a 1e-4 bar is not defined on that scene; with the
XPBD methods it stays far below it. ``chip_smoke.py`` phase 12 holds the
card to the CPU on the default cloth by the card's own spread, measured
the same way in the same run, and on the XPBD cloth at 1e-4."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_scene_files as files
from positionbaseddynamics_tpu.scene.loader import load_scene_dict
from positionbaseddynamics_tpu.solver.step import step as jstep

STEPS = 20
TOL = 1e-4
SDF_RES = 14            # bench_torch.SCENE_SDF_RESOLUTION


def _nudge(s, sign):
    """``s`` with every free particle's x one float32 step toward
    ``sign``·∞."""
    p = s.particles
    x = np.asarray(p.x).copy()
    free = np.asarray(p.inv_mass) > 0
    x[free] = np.nextafter(x[free], np.float32(sign * np.inf))
    return dataclasses.replace(s, particles=dataclasses.replace(
        p, x=jnp.asarray(x)))


@pytest.mark.parametrize("xpbd", [False, True], ids=["defaults", "xpbd"])
def test_cloth_stand_in_float32_spread(tmp_path, xpbd):
    data, base = files.cloth(str(tmp_path), n=51, xpbd=xpbd)
    s = load_scene_dict(data, base_path=base,
                        cache_dir=str(tmp_path / "cache"),
                        max_sdf_resolution=SDF_RES)
    f = jax.jit(lambda st: jstep(st, s.cset, s.config, s.pipeline))
    a = b = s.state
    for i in range(STEPS):
        a, b = f(a), _nudge(f(b), (-1) ** i)
    spread = float(np.abs(np.asarray(a.particles.x)
                          - np.asarray(b.particles.x)).max())
    print(f"cloth stand-in, {'XPBD' if xpbd else 'default'} methods: "
          f"float32 spread {spread!r} after {STEPS} steps")
    if xpbd:
        assert spread < TOL / 10
    else:
        assert spread > TOL
