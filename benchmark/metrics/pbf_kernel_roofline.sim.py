"""``pbf_kernel_roofline.sim``, layer "kernel" (``csrc/pbf_cells.cu``: B3
``pbf_density_lambda_kernel``, B4 ``pbf_corrections_kernel``, B5
``pbf_xsph_kernel``): the least time, at the card's published peaks, of
the fluid steps the traced frames did (steps × their density iterations,
from ``benchmark/work/pbf_dam.py``, whatever launches did them), over the
device time of the kernels whose names hold ``PATTERN``, in percent. A
kernel renamed so that no name holds ``PATTERN`` leaves the metric out;
only a change to the benchmark may repoint it. Moves
``sim_steps_per_s``."""

KIND = "pbf_dam"
PATTERN = "pbf_"


def read(run):
    if run.kind != KIND or run.trace is None:
        return None
    device_s = run.trace.device_seconds(PATTERN)
    if device_s <= 0:
        return None
    return 100.0 * run.least_seconds(KIND) / device_s
