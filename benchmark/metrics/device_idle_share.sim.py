"""``device_idle_share.sim``, layer "device": the share of the traced
slice's window in which no operation ran on the card, ``1 − busy /
window``, the busy time the union of the device operations' intervals,
in percent. Moves ``sim_steps_per_s``."""

LOOP = "sim"


def read(run):
    t = run.trace
    if run.loop != LOOP or t is None or not t.ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
