"""``cloth_kernel_roofline.plan``, layer "kernel"
(``csrc/grid_cloth_step.cu``): the least time, at the card's published
peaks, of the cloth substep work the traced updates did (rollouts ×
horizon × substeps × iterations, from ``benchmark/work/grid_cloth.py``,
whatever launches did it), over the device time of the kernels whose
names hold ``PATTERN``, in percent. A kernel renamed so that no name
holds ``PATTERN`` leaves the metric out; only a change to the benchmark
may repoint it. Moves ``plan_updates_per_s``."""

KIND = "grid_cloth"
PATTERN = "cloth_"


def read(run):
    if run.kind != KIND or run.trace is None:
        return None
    device_s = run.trace.device_seconds(PATTERN)
    if device_s <= 0:
        return None
    return 100.0 * run.least_seconds(KIND) / device_s
