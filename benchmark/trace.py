"""The traced run's reading of the card: ``torch.profiler`` over a short
slice of the loop, its Chrome trace read back as one timeline of the
host's phases (the loop's ``bench.*`` labels and the operators under
them) and the device's operations (kernels, copies, memsets).

The device's busy time is the union of its operations' intervals inside
the slice's ``bench.window`` span, not the sum of their times, so
overlapping operations count once and the idle share is ``1 − busy /
window``.
"""
from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")
WINDOW = "bench.window"


@dataclass
class Trace:
    window_s: float
    busy_s: float
    # device operations inside the window: (name, category, start µs, µs)
    ops: list = field(default_factory=list)
    # idle intervals inside the window: (start µs, µs, host label)
    gaps: list = field(default_factory=list)

    def device_seconds(self, match=None) -> float:
        """Seconds of device operations whose name contains ``match``
        (all of them when None), summed."""
        return sum(d for n, _c, _t, d in self.ops
                   if match is None or match in n) * 1e-6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, summed by name, and
        the longest idle gaps with what the host was doing, in seconds."""
        by_name = {}
        for n, _c, _t, d in self.ops:
            by_name[n] = by_name.get(n, 0.0) + d * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps, key=lambda g: -g[1])[:top]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[lab, d * 1e-6] for _t, d, lab in gaps]}


def _host_label(t: float, host: list) -> str:
    """The innermost ``bench.*`` phase and the innermost operator the host
    was in at time ``t`` (µs)."""
    phase, op = None, None
    for name, ts, dur in host:
        if ts <= t < ts + dur:
            if name.startswith("bench."):
                if phase is None or dur < phase[1]:
                    phase = (name, dur)
            elif op is None or dur < op[1]:
                op = (name, dur)
    return "/".join(x[0] for x in (phase, op) if x) or "host idle"


def read(events: list, gap_labels: int = 40) -> Trace:
    """The :class:`Trace` of a Chrome trace's ``traceEvents``."""
    spans = [e for e in events if e.get("ph") == "X"]
    win = [e for e in spans if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError(f"the trace has no {WINDOW!r} span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    ops = []
    for e in spans:
        if e.get("cat") in DEVICE_CATS:
            t, d = float(e["ts"]), float(e["dur"])
            if t < w1 and t + d > w0:
                ops.append((e["name"], e["cat"], t, d))
    ops.sort(key=lambda o: o[2])
    busy, idle, cur = 0.0, [], w0
    for _n, _c, t, d in ops:
        a, b = max(t, cur), min(t + d, w1)
        if a > cur:
            idle.append((cur, a - cur))
        if b > a:
            busy += b - a
        cur = max(cur, b)
    if w1 > cur:
        idle.append((cur, w1 - cur))
    host = [(e["name"], float(e["ts"]), float(e["dur"])) for e in spans
            if e.get("cat") in HOST_CATS and float(e["ts"]) < w1
            and float(e["ts"]) + float(e["dur"]) > w0]
    longest = sorted(idle, key=lambda g: -g[1])[:gap_labels]
    gaps = [(t, d, _host_label(t + 0.5 * d, host)) for t, d in longest]
    return Trace(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6, ops=ops,
                 gaps=gaps)


def profile(body) -> Trace:
    """Run ``body()`` under ``torch.profiler`` (host and CUDA), read its
    trace and return it. ``body`` opens the ``bench.window`` span and ends
    it after the device has finished. The trace file lives in the temporary
    directory only while it is read."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    acts = [ProfilerActivity.CPU]
    import torch
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with tprofile(activities=acts) as prof:
        body()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return read(events)
