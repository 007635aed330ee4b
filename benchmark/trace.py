"""The traced run's reading of the card: ``torch.profiler`` over a short
slice of the loop, its Chrome trace read back as one timeline of the
host's phases (the loop's ``bench.*`` labels and the operators under
them) and the device's operations (kernels, copies, memsets).

The device's busy time is the union of its operations' intervals inside
the slice's ``bench.window`` span, not the sum of their times, so
overlapping operations count once and the idle share is ``1 − busy /
window``.

The program's own host spans (``pbd.*``, ``utils/telemetry.py`` of the
port) are kept beside them, and each device operation is tied to the
innermost of them that was open on the host thread that launched it: the
launch is the runtime or driver call whose ``args.correlation`` the
operation carries.
"""
from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "bench.window"
PROGRAM = "pbd."


@dataclass
class Trace:
    window_s: float
    busy_s: float
    # device operations inside the window: (name, category, start µs, µs)
    ops: list = field(default_factory=list)
    # the longest idle intervals inside the window: (start µs, µs, host
    # label)
    gaps: list = field(default_factory=list)
    # every idle interval inside the window, in time order: (start µs, µs)
    idle: list = field(default_factory=list)
    # the program's ``pbd.*`` host spans that overlap the window, in order
    # of their start: (name, start µs, µs)
    spans: list = field(default_factory=list)
    # for each of ``ops``, in its order: the innermost ``pbd.*`` span open
    # on the host thread when the operation was launched, or ""
    op_spans: list = field(default_factory=list)

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

    def span_intervals(self, name: str) -> list:
        """The union of the ``spans`` called ``name`` or nested under it by
        name (``name.*``), as sorted, disjoint (start µs, end µs)."""
        return merged((t, t + d) for n, t, d in self.spans
                      if n == name or n.startswith(name + "."))


def merged(intervals) -> list:
    """The union of (start, end) intervals, as sorted, disjoint ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap(a: list, b: list) -> float:
    """The length of the intersection of two lists of sorted, disjoint
    (start, end) intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _correlation(e: dict):
    return (e.get("args") or {}).get("correlation")


def _innermost(launches: list, program: list) -> list:
    """For each launch event (or None), the name of the innermost of the
    ``program`` spans on its thread that was open at its start, or ""."""
    out = [""] * len(launches)
    by_tid, asks = {}, {}
    for e in program:
        by_tid.setdefault(e.get("tid"), []).append(
            (float(e["ts"]), float(e["dur"]), e["name"]))
    for i, la in enumerate(launches):
        if la is not None:
            asks.setdefault(la.get("tid"), []).append((float(la["ts"]), i))
    for tid, points in asks.items():
        opened = sorted(by_tid.get(tid, []), key=lambda s: (s[0], -s[1]))
        stack, j = [], 0
        for t, i in sorted(points):
            while j < len(opened) and opened[j][0] <= t:
                stack.append(opened[j])
                j += 1
            while stack and stack[-1][0] + stack[-1][1] <= t:
                stack.pop()
            if stack:
                out[i] = stack[-1][2]
    return out


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
    dev = []
    for e in spans:
        if e.get("cat") in DEVICE_CATS:
            t, d = float(e["ts"]), float(e["dur"])
            if t < w1 and t + d > w0:
                dev.append(((e["name"], e["cat"], t, d), _correlation(e)))
    dev.sort(key=lambda o: o[0][2])
    ops = [op for op, _c in dev]
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
    program = [e for e in spans if e.get("cat") == "user_annotation"
               and e.get("name", "").startswith(PROGRAM)]
    launch = {}
    for e in spans:
        if e.get("cat") in LAUNCH_CATS and _correlation(e) is not None:
            launch.setdefault(_correlation(e), e)
    op_spans = _innermost([launch.get(c) for _op, c in dev], program)
    mine = sorted(((e["name"], float(e["ts"]), float(e["dur"]))
                   for e in program if float(e["ts"]) < w1
                   and float(e["ts"]) + float(e["dur"]) > w0),
                  key=lambda s: (s[1], -s[2]))
    return Trace(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6, ops=ops,
                 gaps=gaps, idle=idle, spans=mine, op_spans=op_spans)


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
