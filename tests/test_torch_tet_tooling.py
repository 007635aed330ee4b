"""The tet kernel's measurement tooling on the CPU: the text anchors by
which ``scripts/tet_tile_sweep.py`` and ``scripts/tet_phase_probe.py``
edit ``csrc/grid_tet_step.cu``, the box layout the sweep reports beside
each time, and the probe's summary of its stamps. The kernel itself runs
only on the card (``tests/test_torch_kernel_card.py``)."""
import importlib.util
import itertools
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "positionbaseddynamics_tpu_torch" / "csrc" / "grid_tet_step.cu"


def _script(name):
    sys.path.insert(0, str(ROOT / "scripts"))
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tet_tile_sweep_reads_the_shipped_values():
    sweep = _script("tet_tile_sweep")
    values = sweep.source_values(SOURCE.read_text())
    assert set(values) == set(sweep.ANCHORS)
    assert min(values.values()) >= 1


@pytest.mark.parametrize("variant", _script("tet_tile_sweep").VARIANTS)
def test_tet_tile_sweep_builds_each_variant(variant):
    sweep = _script("tet_tile_sweep")
    out = sweep.variant_source(SOURCE.read_text(), variant)
    assert sweep.source_values(out) == dict(zip(sweep.ANCHORS, variant))


@pytest.mark.parametrize("anchor", ["TI", "TK", "kMinBlocks"])
def test_tet_tile_sweep_finds_a_moved_anchor(anchor):
    sweep = _script("tet_tile_sweep")
    src = SOURCE.read_text().replace(f"constexpr int {anchor} = ",
                                     f"constexpr int {anchor}  = ")
    with pytest.raises(RuntimeError, match="anchor not found once"):
        sweep.variant_source(src, (4, 6, 6, 1, 2))
    with pytest.raises(RuntimeError, match="anchor not found once"):
        sweep.source_values(src)


@pytest.mark.parametrize("box,nc,dims", [
    ((8, 8, 8), 1, (80, 36, 36)), ((8, 6, 6), 1, (80, 36, 36)),
    ((8, 6, 6), 2, (13, 7, 5)), ((5, 4, 3), 1, (11, 9, 7)),
    ((8, 6, 6), 1, (2, 2, 2))])
def test_tet_tile_sweep_box_counts(box, nc, dims):
    """The clipped layout against a count of the grid's cells with a
    corner in each box, block by block."""
    got = _script("tet_tile_sweep").box_counts(*box, nc, dims)
    starts = [range(0, n, t) for t, n in zip(box, dims)]
    solved = lanes = 0
    for origin in itertools.product(*starts):
        # cells (c, c + 1 on each axis) of the grid that touch the box
        per_axis = [sum(1 for c in range(n - 1)
                        if c + 1 >= o and c <= o + t - 1)
                    for o, t, n in zip(origin, box, dims)]
        cells = per_axis[0] * per_axis[1] * per_axis[2]
        solved += cells
        lanes += 32 * nc * (-(-((cells + 1) // 2) // (32 * nc))
                            + -(-(cells // 2) // (32 * nc)))
    n_cells = (dims[0] - 1) * (dims[1] - 1) * (dims[2] - 1)
    full = (box[0] + 1) * (box[1] + 1) * (box[2] + 1)
    assert got["blocks"] == len(list(itertools.product(*starts)))
    assert got["solved_over_cells"] == pytest.approx(solved / n_cells)
    assert got["lane_use"] == pytest.approx(solved / lanes)
    assert got["halo_factor"] == pytest.approx(full / (box[0] * box[1]
                                                       * box[2]))
    # one thread takes nc cells of a class
    assert got["threads"] == 32 * (-(-((full + 1) // 2) // (32 * nc))
                                   + -(-(full // 2) // (32 * nc)))


def test_tet_tile_sweep_box_counts_at_the_bar():
    # 9 x 7 x 7 cells: 221 even in 7 warps and 220 odd in 7; the bar's
    # 36 = 6 x 6 vertices take 6 + 4 x 7 + 6 = 40 cells a side
    got = _script("tet_tile_sweep").box_counts(8, 6, 6, 1, (80, 36, 36))
    assert got["threads"] == 448 and got["blocks"] == 10 * 6 * 6
    assert got["solved_over_cells"] == pytest.approx(88 * 40 * 40
                                                     / (79 * 35 * 35))


def test_tet_phase_probe_finds_its_anchors():
    probe = _script("tet_phase_probe")
    src = SOURCE.read_text()
    out = probe.instrument(src)
    for k in range(len(probe.PHASES)):
        assert out.count(f"probe_t{k} = clock64();") == 1
    assert out.count("pbd_tet_probe_read") == 1
    assert probe.ablate_solve(src).count("solve_cell<") == src.count(
        "solve_cell<") - 2
    with pytest.raises(RuntimeError, match="anchor not found once"):
        probe.instrument(src.replace("// ---- 2. solve", "// 2. solve"))
    with pytest.raises(RuntimeError, match="anchor not found once"):
        probe.instrument(src.replace(probe.END, "}\n"))
    out = probe.ablate_memory(src)
    assert "x_in[a * n + vi]" in src and "rx[u][a] = x_in" not in out
    assert out.count("== 1234.5f)") == 2
    with pytest.raises(RuntimeError, match="anchor not found once"):
        probe.ablate_memory(src.replace("ric[u] = ic_g[vi];", "ric[u]=ic_g[vi];"))


def test_tet_phase_probe_summary():
    probe = _script("tet_phase_probe")
    # two blocks one after the other on SM 0, one on SM 1:
    # [smid, stage, solve, gather_write, end]
    rows = [[0, 0, 100, 600, 800], [0, 800, 900, 1500, 1700],
            [1, 0, 90, 700, 900]]
    got = probe.summarize(rows)
    assert got["phases"]["solve"] == {"mean": 570, "min": 500, "max": 610,
                                      "share": pytest.approx(570 / (2600 / 3))}
    assert got["blocks_per_sm"] == {2: 1, 1: 1}
    assert got["sm_span_cycles_max"] == 1700
    assert got["resident_blocks_mean"] == pytest.approx(1.0)
