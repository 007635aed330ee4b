"""``planner_aux_ms.plan``, layer "planner" (``mpc/planners.py``,
``mpc/costs.py``): device milliseconds an update in operations other
than the configurations' step kernels (names holding one of
``STEP_KERNELS``): the rollouts' expansion, control, costs, weights,
plane conversions and copies. Moves ``plan_updates_per_s``."""

STEP_KERNELS = ("cloth_", "tet_")


def read(run):
    if run.loop != "mpc" or run.trace is None or not run.trace.ops:
        return None
    other = sum(d for n, _c, _t, d in run.trace.ops
                if not any(k in n for k in STEP_KERNELS))
    return other * 1e-3 / len(run.window.periods)
