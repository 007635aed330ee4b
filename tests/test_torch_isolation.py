"""The port stands alone: importing every module of
``positionbaseddynamics_tpu_torch`` loads neither ``jax`` nor the JAX
package, and no source of the port (nor ``chip_smoke.py`` or
``bench_torch.py``) imports them."""
import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import positionbaseddynamics_tpu_torch as port

ROOT = Path(__file__).resolve().parents[1]
PORT_DIR = Path(port.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "positionbaseddynamics_tpu")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PORT_DIR)], prefix="positionbaseddynamics_tpu_torch."))


def test_port_has_the_slice_modules():
    mods = set(_port_modules())
    for name in ("ops.integration", "ops.mathutils", "ops.pbd", "ops.xpbd",
                 "solver.state", "solver.coloring", "solver.constraints",
                 "solver.grid_cloth",
                 "solver.grid_cloth_cuda", "solver.grid_tet",
                 "solver.grid_tet_cuda", "solver.step", "models.mesh",
                 "models.builders", "_build", "convert", "fluids.sph",
                 "fluids.neighborhood", "fluids.cellgrid",
                 "fluids.cellgrid_cuda", "fluids.model",
                 "fluids.classgrid", "mpc.controls", "mpc.costs",
                 "mpc.planners", "ops.quaternion", "ops.rigidbody",
                 "solver.joints", "utils.npquat", "utils.massprops",
                 "collision", "collision.sdf", "collision.sampling",
                 "collision.bvh", "collision.csdf", "collision.bake",
                 "collision.detection", "collision.batched",
                 "collision.contacts", "collision.solid"):
        assert f"positionbaseddynamics_tpu_torch.{name}" in mods, name


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PORT_DIR.rglob("*.py"))
                         + [ROOT / "chip_smoke.py", ROOT / "bench_torch.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"
