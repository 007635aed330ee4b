#!/usr/bin/env python3
"""Count the PyTorch operations one step of the loaded stand-in scenes
dispatches, on the CPU, as a proxy for the device launches a step takes
on the card (``rod_launch_count.py``'s counter).

    python3 scripts/scene_launch_count.py

Writes ``bench_torch``'s three stand-ins (PileScene, the contact scene,
ClothOnBunny with the loader's default cloth methods and with XPBD's)
into a temporary directory, loads each
with ``bench_torch.load_bench_scene`` on the CPU, runs one step of
``make_step_fn`` under a ``TorchDispatchMode`` and prints one JSON line
per scene: the route, ``ops``, ``views`` and ``compute`` (each about one
kernel launch on the card), with the ten most frequent computing
operators. Nothing here times anything."""
from __future__ import annotations

import json
import os
import sys
import tempfile
import warnings

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from rod_launch_count import count  # noqa: E402  (this directory)


def main() -> int:
    import bench_torch as bt
    from positionbaseddynamics_tpu_torch.solver import make_step_fn

    cpu = torch.device("cpu")
    with tempfile.TemporaryDirectory() as d:
        for name, path in (
                ("pile", bt.write_pile_scene(d)),
                ("contact", bt.write_contact_scene(d)),
                ("cloth", bt.write_cloth_scene(d)),
                ("cloth_xpbd", bt.write_cloth_scene(
                    os.path.join(d, "xpbd"), xpbd=True))):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")     # the skipped bodies
                s = bt.load_bench_scene(path, cpu)
            fn = make_step_fn(s.cset, s.config, cpu, pipeline=s.pipeline)
            print(json.dumps({"scene": name, "path": fn.path,
                              "particles": s.state.particles.n,
                              "bodies": len(s.rigid_ids),
                              **count(fn, s.state)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
