"""Phase timing (port of ``positionbaseddynamics_tpu/utils/timing.py``).

Equivalent of the reference's hierarchical averaging timers
(``Utils/Timing.h:12-100``; ``START_TIMING``/``STOP_TIMING_AVG`` hooked
around "simulation step", "position constraints projection" and
"collision detection" at ``TimeStepController.cpp:77,132,191``). The
timers run the step itself, ``repeats`` calls after one warm-up call,
under a CPU-only ``torch.profiler``, and read each phase from the step's
own spans (:mod:`.telemetry`): a phase's time is the host time of its
spans over ``repeats``, so the phases time the route the step takes.

What they measure is host time under the profiler: the profiler's own
cost is in it (on the card's host it reads the kernel route's step 2 to
2.5 times slower than an untraced step), and the device time of
asynchronous launches is not, since no phase waits for the card. A
torch profiler records one session at a time, so ``measure`` cannot run
inside another profiler's recording.

For kernel-level drill-down use ``torch.profiler`` with CUDA activity
around the step; these timers are the cheap always-available summary.
"""
from __future__ import annotations

import torch

from .._device import resolve_device

#: Each phase and the spans whose host time it sums: the step, the
#: constraint projection (the substeps on the PyTorch route, the kernel
#: wrapper on the kernel route) and collision detection.
PHASE_SPANS = {
    "simulation step": ("pbd.step",),
    "position constraints projection": ("pbd.step.substeps",
                                        "pbd.kernel.cloth", "pbd.kernel.tet"),
    "collision detection": ("pbd.step.collision",),
}


class PhaseTimers:
    """Average host time per phase, ``Timing::printAverageTimes``
    style, on ``device`` (None means CUDA): the host time of the step's
    spans under a CPU-only profiler (see the module's docstring)."""

    def __init__(self, cset, cfg, pipeline=None, device=None):
        from ..solver.step import make_step_fn

        self._device = dev = resolve_device(device)
        self._fn = make_step_fn(cset, cfg, dev, pipeline=pipeline)
        self._phases = ["simulation step", "position constraints projection"]
        if pipeline is not None and pipeline.active:
            self._phases.append("collision detection")
        self._sums = {k: 0.0 for k in self._phases}
        self._counts = {k: 0 for k in self._phases}

    def _sync(self):
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def measure(self, state, repeats: int = 5):
        """Run the step ``repeats`` times on ``state`` (after one untimed
        warm-up call) under a profiler of its own and accumulate each
        phase's average host time. Not while another profiler records."""
        from torch.profiler import ProfilerActivity, profile

        self._fn(state)                                  # warm-up
        self._sync()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(repeats):
                self._fn(state)
            self._sync()
        us = {k: 0.0 for k in self._phases}
        for ev in prof.events():
            for k in self._phases:
                if ev.name in PHASE_SPANS[k]:
                    us[k] += ev.cpu_time_total
        for k in self._phases:
            self._sums[k] += us[k] * 1e-6 / repeats
            self._counts[k] += 1
        return self.averages()

    def averages(self) -> dict:
        """Phase → average seconds (``printAverageTimes`` analogue)."""
        return {k: (self._sums[k] / self._counts[k] if self._counts[k]
                    else 0.0) for k in self._phases}

    def report(self) -> str:
        lines = ["---- average times ----"]
        for k, v in self.averages().items():
            lines.append(f"  {k}: {1e3 * v:.3f} ms")
        return "\n".join(lines)
