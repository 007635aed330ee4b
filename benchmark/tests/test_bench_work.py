"""The frozen work counts against the bounds the repository recorded
for B1 and B2 at their recorded shapes (PERF.md: 0.376 ms a substep of
the 320×320 cloth at 256 rollouts, bytes-bound; 0.009243 ms an iteration
of the 80×36×36 bar at 4 rollouts, operations-bound), and against
``chip_smoke.py``'s own functions where that script is present."""
import pytest

from benchmark.work import grid_cloth, grid_tet, peaks

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
