"""The frozen work counts against the bounds the repository recorded
for B1 and B2 at their recorded shapes (PERF.md: 0.376 ms a substep of
the 320×320 cloth at 256 rollouts, bytes-bound; 0.009243 ms an iteration
of the 80×36×36 bar at 4 rollouts, operations-bound), and against
``chip_smoke.py``'s own functions where that script is present; the
dam's pair counts against the block's lattice."""
import json

import pytest

from benchmark import spec
from benchmark.work import grid_cloth, grid_tet, pbf_dam, peaks

CLOTH = {"width": 320, "height": 320}
BAR = {"width": 80, "height": 36, "depth": 36}


def test_cloth_substep_bound_at_256_rollouts():
    t, by = peaks.least_seconds(*grid_cloth.substep(CLOTH, 256, 1))
    assert by == "bytes"
    assert t * 1e3 == pytest.approx(0.376, abs=5e-4)


def test_tet_iteration_bound_at_4_rollouts():
    t, by = peaks.least_seconds(*grid_tet.substep(BAR, 4, 1))
    assert by == "operations"
    assert t * 1e3 == pytest.approx(0.009243, abs=5e-7)


@pytest.mark.parametrize("nb", [1, 4, 256])
def test_counts_agree_with_chip_smoke(nb):
    cs = pytest.importorskip("chip_smoke")
    ms, by = cs.fused_bound(nb, substeps=1)
    t, by2 = peaks.least_seconds(*grid_cloth.substep(CLOTH, nb, 1))
    assert (t * 1e3, by2) == (pytest.approx(ms, rel=1e-12), by)
    b = cs.tet_bound((80, 36, 36), nb)
    t, by2 = peaks.least_seconds(*grid_tet.substep(BAR, nb, 1))
    assert (t * 1e3, by2) == (pytest.approx(b["ms"], rel=1e-12), b["by"])


DAM = json.loads((spec.ROOT / "benchmark/configs/dam-100k.json").read_text())


def test_dam_rest_pairs_are_the_lattice_counts():
    """Fluid pairs of the 42×56×42 block at spacing 2r within the support
    4r: the 26 lattice offsets of squared length 1, 2 and 3, each taken by
    every particle whose neighbour there is inside the block; boundary
    pairs as counted when this count was frozen."""
    n, nb, fluid, boundary = pbf_dam.rest_pairs(DAM)
    offs = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
            for c in (-1, 0, 1) if (a, b, c) != (0, 0, 0)]
    nx, ny, nz = DAM["block"]
    lattice = sum((nx - abs(a)) * (ny - abs(b)) * (nz - abs(c))
                  for a, b, c in offs)
    assert (n, nb) == (98_784, 160_176)
    assert fluid == lattice == 2_453_632
    assert boundary == 156_602


def test_dam_step_bound():
    flops, nbytes = pbf_dam.substep(DAM, 1, 5)
    n, nb, fluid, boundary = pbf_dam.rest_pairs(DAM)
    assert flops == 5 * (15 * n + 44 * (fluid + boundary)
                         + 6 * n + 31 * fluid + 30 * boundary) \
        + 6 * n + 31 * fluid
    t, by = peaks.least_seconds(flops, nbytes)
    assert by == "bytes" and t * 1e6 == pytest.approx(21.10, abs=0.01)
    assert pbf_dam.substep(DAM, 2, 5) == (2 * flops, 2 * nbytes)


def test_dam_counts_agree_with_chip_smoke():
    cs = pytest.importorskip("chip_smoke")
    names = {"density_lambda": "pbf_density_lambda",
             "corrections": "pbf_corrections", "xsph": "pbf_xsph"}
    for mine, theirs in names.items():
        assert pbf_dam.FLUID_PAIR_FLOPS[mine] == \
            cs.PBF_PAIR_OPS[theirs]["fluid"]
        assert pbf_dam.BOUNDARY_PAIR_FLOPS[mine] == \
            cs.PBF_PAIR_OPS[theirs]["boundary"]
        assert pbf_dam.PARTICLE_FLOPS[mine] == cs.PBF_SLOT_OPS[theirs]
