"""``plan_expand_ms.plan``, layer "planner" (``mpc/planners.py``:
``make_sequence_cost``'s ``_expand_state`` inside the span
``pbd.plan.expand``, the nominal state copied to every rollout):
``plan_control_ms.plan``'s reading for ``SPAN``. Moves
``plan_updates_per_s``."""
from benchmark import spec

SPAN = "pbd.plan.expand"
_span_ms = spec.reader("plan_control_ms.plan").span_ms


def read(run):
    return _span_ms(run, SPAN)
