"""The measurement tooling around the port's kernels, on the CPU: the
``-Xptxas -v`` parser and the one-pass bar of ``chip_smoke.py``, and the
text anchors by which the measurement scripts under ``scripts/`` edit the
kernel sources. The kernels themselves run only on the card
(``tests/test_torch_kernel_card.py``)."""
import importlib.util
from pathlib import Path

import pytest
import torch

import chip_smoke

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "positionbaseddynamics_tpu_torch" / "csrc"


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ptxas_report_names_each_kernel():
    """The anonymous namespace puts a file hash with digits before each
    kernel's name; the parser keeps the name and each number."""
    log = (
        "ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__a6544aa6"
        "_12_pbf_cells_cu_dbc0177025pbf_density_lambda_kernelENS_5CellsE' "
        "for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN45_GLOBAL__N__a6544aa6_"
        "12_pbf_cells_cu_dbc0177025pbf_density_lambda_kernelENS_5CellsE\n"
        "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 63 registers, used 0 barriers, 10576 bytes "
        "smem, 424 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z20cloth_substep_kernelPKf'"
        " for 'sm_90a'\n"
        "ptxas info    : Used 40 registers, used 1 barriers\n")
    report, lines = chip_smoke.ptxas_report({"pbf_cells": log})
    assert report == {
        "pbf_density_lambda_kernel": {"stack": 8, "spill_stores": 4,
                                      "spill_loads": 12, "registers": 63,
                                      "smem": 10576},
        "cloth_substep_kernel": {"registers": 40}}
    assert len(lines) == 3
    assert all(line.startswith("pbf_cells ") for line in lines)


def test_ptxas_report_keeps_template_instances_apart():
    """A kernel templated on an integer is one entry per instance, named
    ``kernel<n>``, inside the anonymous namespace or outside it."""
    log = (
        "ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__5e0c5a2b"
        "_18_grid_cloth_step_cu_a1b2c3d420cloth_substep_kernelILi1EEEvPKfS2_'"
        " for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN45_GLOBAL__N__5e0c5a2b_18"
        "_grid_cloth_step_cu_a1b2c3d420cloth_substep_kernelILi1EEEvPKfS2_\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 48 registers, used 1 barriers, 424 bytes "
        "cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z20cloth_substep_kernel"
        "ILi4EEvPKf' for 'sm_90a'\n"
        "ptxas info    : Used 96 registers, used 1 barriers\n")
    report, lines = chip_smoke.ptxas_report({"grid_cloth_step": log})
    assert report == {
        "cloth_substep_kernel<1>": {"stack": 0, "spill_stores": 0,
                                    "spill_loads": 0, "registers": 48},
        "cloth_substep_kernel<4>": {"registers": 96}}
    assert len(lines) == 3


def _ulps(x, n):
    x = torch.tensor([x], dtype=torch.float32)
    for _ in range(abs(n)):
        x = torch.nextafter(x, torch.tensor([float("inf") if n > 0
                                             else float("-inf")]))
    return x


@pytest.mark.parametrize("plain,kernel,ok", [
    (16.5, 1, True),           # one float32 step (1.9e-6) past 16
    (16.5, 2, False),          # two steps
    (-33.0, -1, True),         # one step (3.8e-6) away from zero past 32
    (8.0, 1, True),            # the bar's edge: one step at 8 is 9.5e-7
    (0.5, 1.1e-6, False),      # 1.1e-6 below 8 is past the 1e-6 bar
    (7.5, 9.5e-7, True),       # two steps at 7.5, within 1e-6
])
def test_one_pass_bar(plain, kernel, ok):
    """The one-pass bar: 1e-6 absolute, or one float32 step where the
    plain value is 8 or more in magnitude. ``kernel`` is a count of float32
    steps from ``plain`` when it is an int, else an offset."""
    p = torch.tensor([plain, 1.0, 0.0], dtype=torch.float32)
    k = p.clone()
    k[0] = (_ulps(plain, kernel) if isinstance(kernel, int)
            else torch.tensor(plain + kernel, dtype=torch.float32))
    bar = chip_smoke.one_pass_bar(k, p)
    assert bar["ok"] is ok
    assert bar["differ"] == 1 and bar["fail"] == (0 if ok else 1)
    assert bar["values_step"] == (1 if abs(plain) >= 8 else 0)
    assert bar["values_abs"] == 3 - bar["values_step"]
    assert bar["max_magnitude_differing"] == abs(p[0].item())
    assert bar["max_abs_err"] == (k[0] - p[0]).abs().item()


def test_one_pass_bar_counts_nothing_when_equal():
    p = torch.tensor([[20.0, -3.0], [0.0, 9.0]])
    bar = chip_smoke.one_pass_bar(p.clone(), p)
    assert bar == {"values_abs": 2, "values_step": 2, "differ": 0, "fail": 0,
                   "max_abs_err": 0.0, "max_magnitude_differing": 0.0,
                   "ok": True}


def test_pbf_phase_probe_finds_its_anchors():
    """``scripts/pbf_phase_probe.py`` stamps B3 by exact text anchors in
    ``csrc/pbf_cells.cu``; each must be found once (B4 and B5 share the
    staged walk B3 calls)."""
    probe = _script("pbf_phase_probe")
    src = (CSRC / "pbf_cells.cu").read_text()
    out = probe.instrument(src)
    assert out.count("PROBE_MARK(") == src.count("PROBE_MARK(") + 4 + 1
    assert "probe_read" in out


@pytest.mark.parametrize("variant", range(6))
def test_pbf_stage_sweep_builds_each_variant(variant):
    sweep = _script("pbf_stage_sweep")
    src = (CSRC / "pbf_cells.cu").read_text()
    fluid, boundary, blocks, ablate = sweep.VARIANTS[variant]
    out = sweep.variant_source(src, fluid, boundary, blocks, ablate)
    assert f"constexpr int kStageFluid = {fluid};" in out
    assert f"constexpr int kMinBlocks = {blocks};" in out


def test_cloth_phase_probe_finds_its_anchors():
    """``scripts/cloth_phase_probe.py`` stamps each phase header of the
    cloth kernel and its end, each found once."""
    probe = _script("cloth_phase_probe")
    src = (CSRC / "grid_cloth_step.cu").read_text()
    out = probe.instrument(src)
    assert out.count("PROBE_BEGIN\n") == 1
    for k in range(1, len(probe.PHASES)):
        assert out.count(f"PROBE_PHASE({k})\n") == 1
    assert out.count("  PROBE_END\n") == 1
    with pytest.raises(RuntimeError, match="anchor not found once"):
        probe.instrument(src.replace("// ---- bending gather", "// bending"))


def test_cloth_tile_sweep_builds_each_variant():
    sweep = _script("cloth_tile_sweep")
    src = (CSRC / "grid_cloth_step.cu").read_text()
    for variant in sweep.VARIANTS:
        out = sweep.variant_source(src, *variant)
        if variant[2] is not None:
            assert f"constexpr int kExtraCells = {variant[2]};" in out
        assert f"constexpr int TX = {variant[0]};" in out
        assert f"constexpr int TY = {variant[1]};" in out
