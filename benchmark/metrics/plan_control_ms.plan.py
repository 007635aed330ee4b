"""``plan_control_ms.plan``, layer "planner" (``mpc/planners.py``:
``make_sequence_cost``, each ``control_model.apply`` inside the span
``pbd.plan.control``): the device milliseconds an update of the
operations launched while ``SPAN`` was the innermost ``pbd.*`` span open
on the host, whichever kernels they are. None where the trace holds no
such operation. Moves ``plan_updates_per_s``."""

LOOP = "mpc"
SPAN = "pbd.plan.control"


def span_ms(run, span: str):
    """Device ms an update launched with ``span`` innermost, or None."""
    t = run.trace
    if run.loop != LOOP or t is None or not run.window.periods:
        return None
    ds = [d for (_n, _c, _t, d), s in zip(t.ops, t.op_spans) if s == span]
    if not ds:
        return None
    return sum(ds) * 1e-3 / len(run.window.periods)


def read(run):
    return span_ms(run, SPAN)
