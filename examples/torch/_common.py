"""Shared headless-demo harness of the port's examples (the counterpart of
``examples/_common.py``): the demo's scene built on the card (or on the
CPU with ``--device cpu``), stepped through ``make_step_fn``, a summary
print and an optional npz trajectory export (the DemoBase export path,
``Demos/Common/DemoBase.h:78-95``, without the GUI).

Each demo exposes ``build(args, device)``, which returns the :class:`Demo`
its :func:`simulate` call needs, so that a script or a test can build the
demo's scene without running it, and ``main(argv=None)``."""
import argparse
import importlib.util
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

EXAMPLES = os.path.dirname(os.path.abspath(__file__))
# allow running straight from the examples/torch/ directory of a checkout
sys.path.insert(0, os.path.join(EXAMPLES, "..", ".."))


@dataclass
class Demo:
    """A built demo scene: what :func:`simulate` steps, and the handles
    its summary lines read."""

    state: Any
    cset: Any
    cfg: Any
    pipeline: Any = None
    info: dict = field(default_factory=dict)


def demo_args(description, steps=200):
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--steps", type=int, default=steps)
    ap.add_argument("--export-npz", default=None,
                    help="save the particle/rigid trajectory to this npz")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, the plain PyTorch route")
    return ap


def device_of(args) -> torch.device:
    """The demo's device; exits 1 when CUDA is asked for and missing."""
    from positionbaseddynamics_tpu_torch._device import resolve_device

    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        print("CUDA is not available; pass --device cpu to run the plain "
              "PyTorch route on the CPU", file=sys.stderr)
        sys.exit(1)
    return resolve_device(args.device)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def simulate(demo: Demo, steps, export_npz=None, collect_every=8):
    """Step ``demo`` ``steps`` times after one warm-up step, as the JAX
    harness does; print steps/s and return the final state. Collects every
    ``collect_every``-th frame when exporting (the reference renders every
    8 steps)."""
    from positionbaseddynamics_tpu_torch.solver import make_step_fn

    state = demo.state
    dev = state.particles.x.device
    fn = make_step_fn(demo.cset, demo.cfg, dev, pipeline=demo.pipeline)
    state = fn(state)                             # warm-up
    sync(dev)
    frames_x, frames_r = [], []
    t0 = time.perf_counter()
    for i in range(steps):
        state = fn(state)
        if export_npz and i % collect_every == 0:
            if state.particles.x.shape[0]:
                frames_x.append(host(state.particles.x))
            if state.rigid is not None:
                frames_r.append(host(state.rigid.x))
    sync(dev)
    dt = time.perf_counter() - t0
    print(f"{steps} steps in {dt:.2f}s -> {steps / dt:.1f} steps/s")

    finite = True
    if state.particles.x.shape[0]:
        finite &= bool(torch.isfinite(state.particles.x).all())
    if state.rigid is not None:
        finite &= bool(torch.isfinite(state.rigid.x).all())
    print(f"finite: {finite}")
    if not finite:
        sys.exit(1)

    if export_npz:
        out = {}
        if frames_x:
            out["particles"] = np.stack(frames_x)
        if frames_r:
            out["rigid"] = np.stack(frames_r)
        np.savez(export_npz, **out)
        print(f"trajectory saved to {export_npz}")
    return state


def load_example(name):
    """``examples/torch/<name>.py`` loaded by path as a module of its own
    (the demos are scripts, not a package)."""
    spec = importlib.util.spec_from_file_location(
        "torch_example_" + name, os.path.join(EXAMPLES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_demo(module, argv=(), device=None) -> Demo:
    """``module.build`` at the flags ``argv`` (the demo's defaults for the
    rest) on ``device``, without running it: how a script or a test
    builds a demo's scene."""
    ap = demo_args(module.__doc__)
    if hasattr(module, "add_args"):
        module.add_args(ap)
    args = ap.parse_args(list(argv))
    return module.build(args, device)


def run(doc, build, report, steps=200, add_args=None, announce=None,
        argv=None):
    """A demo's ``main``: parse ``argv`` (``--steps``, ``--export-npz``,
    ``--device`` and the demo's own ``add_args(ap)``), ``build(args,
    device)``, ``announce(demo)`` when given, :func:`simulate`, then
    ``report(demo, final state)``."""
    ap = demo_args(doc, steps=steps)
    if add_args is not None:
        add_args(ap)
    args = ap.parse_args(argv)
    demo = build(args, device_of(args))
    if announce is not None:
        announce(demo)
    final = simulate(demo, args.steps, export_npz=args.export_npz)
    report(demo, final)
    return 0


def p(label, value):
    print(f"{label}: {value}")
