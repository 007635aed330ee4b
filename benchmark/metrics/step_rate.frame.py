"""``step_rate.frame``, layer "step route": the steps a second of a sim
loop's untraced slice in the traced run (the mix's
``trace.untraced_seconds``), on the harness's host clock. It stands, per
layer, for ``sim_steps_per_s`` in the sim cells whose rate spreads too
widely from process to process to be held end to end; there it moves
``sim_frame_p95_ms``."""


def read(run):
    w = run.untraced
    if w is None or not w.periods or w.seconds <= 0:
        return None
    return w.steps / w.seconds
