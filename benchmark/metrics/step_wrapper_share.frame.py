"""``step_wrapper_share.frame``, layer "kernel wrapper"
(``solver/grid_cloth_cuda.py``, ``solver/grid_tet_cuda.py``: the kernel
wrappers' checks, output allocations and launches, inside the spans
``pbd.kernel.*``): the share of the host's time inside steps
(``pbd.step``) that it spends inside those spans, in percent, over the
steps that overlap the traced slice. Both are read under the profiler:
its cost at each launch, and the host's speed in the run, fall on both,
so the share holds steady where the wrapper's microseconds do not. A
change to the rest of the step moves it too (``step_host_ms.frame``
reads the whole step). None where the trace holds no step span or no
wrapper span inside one. Moves ``sim_frame_p95_ms``, in the sim cells
whose steps a second are reported per layer (``step_rate.frame``)."""
from benchmark import trace

LOOP = "sim"
STEP, WRAPPER = "pbd.step", "pbd.kernel"


def read(run):
    t = run.trace
    if run.loop != LOOP or t is None:
        return None
    step = t.span_intervals(STEP)
    inside = trace.overlap(t.span_intervals(WRAPPER), step)
    if inside <= 0:
        return None
    return 100.0 * inside / sum(b - a for a, b in step)
