"""The measurement tooling around the PBF kernels, on the CPU: the
``-Xptxas -v`` parser of ``chip_smoke.py``. The kernels themselves run only
on the card (``tests/test_torch_kernel_card.py``)."""
import chip_smoke


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
