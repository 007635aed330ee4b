"""``device_idle_share.frame``: ``device_idle_share.sim``'s reading, in the
sim cells whose steps a second are reported per layer
(``step_rate.frame``); there it moves ``sim_frame_p95_ms``."""
from benchmark import spec

read = spec.reader("device_idle_share.sim").read
