"""``idle_in_step_share.frame``, layer "step route" (``solver/step.py``:
``make_step_fn``'s step, inside the span ``pbd.step``): the share of the
device's idle time in the traced slice during which the host was inside
a step, in percent: how much of the card's waiting the step route's host
code accounts for, against the loop's own work between steps. None where
the trace holds no device operation or no step span. Moves
``sim_frame_p95_ms``, in the sim cells whose steps a second are reported
per layer (``step_rate.frame``)."""
from benchmark import trace

LOOP = "sim"
SPAN = "pbd.step"


def read(run):
    t = run.trace
    if run.loop != LOOP or t is None or not t.ops:
        return None
    step = t.span_intervals(SPAN)
    idle = [(a, a + d) for a, d in t.idle]
    total = sum(d for _a, d in t.idle)
    if not step or total <= 0:
        return None
    return 100.0 * trace.overlap(step, idle) / total
