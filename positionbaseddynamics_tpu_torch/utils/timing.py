"""Phase timing (port of ``positionbaseddynamics_tpu/utils/timing.py``).

Equivalent of the reference's hierarchical averaging timers
(``Utils/Timing.h:12-100``; ``START_TIMING``/``STOP_TIMING_AVG`` hooked
around "simulation step", "position constraints projection" and
"collision detection" at ``TimeStepController.cpp:77,132,191``). Each
phase is a function of the state; its time is the wall time of
``repeats`` calls after one warm-up call, the card synchronised at both
ends, over ``repeats``.

For kernel-level drill-down use ``torch.profiler`` around the step; these
timers are the cheap always-available summary.
"""
from __future__ import annotations

import time

import torch

from .._device import resolve_device


class PhaseTimers:
    """Average wall-clock per phase, ``Timing::printAverageTimes``
    style, on ``device`` (None means CUDA)."""

    def __init__(self, cset, cfg, pipeline=None, device=None):
        from ..solver.step import _substep, batch_passes, make_step_fn

        self._device = dev = resolve_device(device)
        self._phases = {}
        self._phases["simulation step"] = make_step_fn(
            cset, cfg, dev, pipeline=pipeline)
        if cset.device is not None and cset.device != dev:
            cset = cset.to(dev)
        h = cfg.dt / cfg.substeps
        passes = batch_passes(cset, cfg, cset.n_particles)

        def projection(state):
            return _substep(state, cset, h, cfg, passes)

        self._phases["position constraints projection"] = projection

        if pipeline is not None and pipeline.active:
            if pipeline.device not in (None, dev):
                pipeline = pipeline.to(dev)

            def detection(state):
                out = []
                r = state.rigid
                if r is not None and pipeline.rb_pairs:
                    out.append(pipeline.detect_rigid(r))
                p = state.particles
                if r is not None and pipeline.particle_groups:
                    out.append(pipeline.detect_particles(
                        p.x, p.v, p.inv_mass, r))
                if pipeline.solid_pairs:
                    out.append(pipeline.detect_solids(p.x, p.v, p.inv_mass))
                return out

            self._phases["collision detection"] = detection

        self._sums = {k: 0.0 for k in self._phases}
        self._counts = {k: 0 for k in self._phases}

    def _sync(self):
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def measure(self, state, repeats: int = 5):
        """Run each phase ``repeats`` times on ``state`` (after one untimed
        warm-up call) and accumulate averages."""
        for name, fn in self._phases.items():
            fn(state)                                    # warm-up
            self._sync()
            t0 = time.perf_counter()
            for _ in range(repeats):
                fn(state)
            self._sync()
            self._sums[name] += (time.perf_counter() - t0) / repeats
            self._counts[name] += 1
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
