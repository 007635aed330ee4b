"""Spans and counters at the port's layer boundaries.

Spans go to ``torch.profiler``, which is their store, clock and exporter:
while a profiler records, :func:`span` opens
``torch.profiler.record_function(name)``, so the span lands on the
profiler's host timeline beside the device operations launched inside it,
its parent the enclosing span, and ``export_chrome_trace`` writes it as a
``user_annotation`` event. Otherwise :func:`span` returns one shared null
context after a single check, so a span costs one C call and an empty
``with`` when nothing records. The sim step checks once, through
:func:`recording`, and takes a route without spans when nothing records. Every span name starts with ``pbd.``:

* ``pbd.kernels.load``: the kernel libraries' build and load
  (``_build.build_all``);
* ``pbd.scene.build``: ``SceneBuilder.build``; ``pbd.route.plan``: the
  step route's choice (``solver.step._route``);
* ``pbd.step``: one sim step; inside it ``pbd.step.planes`` (the kernel
  route's conversions into and out of component planes) or, on the
  PyTorch route, ``pbd.step.substeps``, ``pbd.step.velocity`` and
  ``pbd.step.collision``;
* ``pbd.kernel.cloth``, ``pbd.kernel.tet``, ``pbd.kernel.pbf_*``: one
  kernel wrapper call, its checks, output allocations and launches;
* ``pbd.mppi.update`` (``pbd.mppi.weights``), ``pbd.cem.update``
  (``pbd.cem.refit``) and, inside a sequence cost, ``pbd.plan.rollouts``
  with ``pbd.plan.expand``, ``pbd.plan.control``, ``pbd.plan.cost`` and
  the horizon's ``pbd.step`` spans.

Counters are always on: a plain dict of numbers, added to by
:func:`count`. They count launches (``kernel.<wrapper>.launches``; of
the cloth kernel's per-substep launches, those of its wide schedule also
in ``kernel.cloth_substep.wide_launches``),
kernel-library builds and loads (``kernels.nvcc_builds``,
``kernels.libraries_loaded``) and one-shot seconds (``kernels.load_s``).
They are computed from shapes and the host clock, never from a device
value, so counting never synchronises with the card. The counters are
one per process and are not locked: count from one thread. :func:`reset`
clears the launch counters and keeps the kernel library's (``kernels.*``),
which count what a process does once.

Wrap any run in ``torch.profiler.profile`` to see the spans on the device
timeline; read :func:`counters` for launches and library loads.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Dict

import torch

#: True exactly while a torch profiler records.
recording = torch.autograd._profiler_enabled
_NULL = contextlib.nullcontext()
_counts: Dict[str, float] = {}
_KEPT = "kernels."              # the kernel library's one-shot counters


def span(name: str):
    """A context manager for the span ``name`` (``pbd.`` first): a
    ``record_function`` while a torch profiler records, else a shared
    null context."""
    if recording():
        return torch.profiler.record_function(name)
    return _NULL


def traced(name: str):
    """Decorate a function to run inside :func:`span` ``name``; with
    nothing recording the call costs the check and no context."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if recording():
                with torch.profiler.record_function(name):
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _counts[name] = _counts.get(name, 0) + n


def counters() -> Dict[str, float]:
    """A copy of every counter."""
    return dict(_counts)


def launches(kernel: str) -> float:
    """The launches counted in ``kernel.<kernel>.launches`` (0 if none)."""
    return _counts.get(f"kernel.{kernel}.launches", 0)


def reset() -> None:
    """Clear every counter but the kernel library's ``kernels.*``: the
    libraries are built and loaded once a process, so those never count
    again."""
    for name in [n for n in _counts if not n.startswith(_KEPT)]:
        del _counts[name]
