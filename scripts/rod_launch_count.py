#!/usr/bin/env python3
"""Count the PyTorch operations one step of the rod benches dispatches, on
the CPU, as a proxy for the device launches a step takes on the card.

    python3 scripts/rod_launch_count.py [--rod-batch N] [--tree-segments S]

Builds ``bench_torch.py --rods``' scene (``--rod-batch`` rods of 51
points on the rod lattice) and ``--tree``'s (``--tree-segments`` stiff-rod
segments, the scheduled elimination, and the dense solve beside it), runs
one step of each under a ``TorchDispatchMode`` and prints one JSON line
per scene: ``ops`` (every dispatched operator), ``views`` (those whose
result aliases an input: no launch on the card) and ``compute`` (the
others, each about one kernel launch on the card), with the ten most
frequent computing operators. Nothing here times anything."""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


class OpCounter(TorchDispatchMode):
    """Counts the dispatched operators, split into views and the rest."""

    def __init__(self):
        super().__init__()
        self.compute = collections.Counter()
        self.views = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        rets = func._schema.returns
        if rets and rets[0].alias_info is not None \
                and not rets[0].alias_info.is_write:
            self.views += 1
        else:
            self.compute[str(func.overloadpacket.__name__)] += 1
        return func(*args, **(kwargs or {}))


def count(fn, state) -> dict:
    fn(state)                                    # warm-up, lazy tables
    with OpCounter() as c:
        fn(state)
    n = sum(c.compute.values())
    return {"ops": n + c.views, "views": c.views, "compute": n,
            "top": c.compute.most_common(10)}


def main() -> int:
    import bench_torch as bt
    from positionbaseddynamics_tpu_torch.solver import StepConfig, make_step_fn

    ap = argparse.ArgumentParser()
    ap.add_argument("--rod-batch", type=int, default=1024)
    ap.add_argument("--tree-segments", type=int, default=bt.TREE_SEGMENTS)
    args = ap.parse_args()
    cpu = torch.device("cpu")
    state, cset = bt.rod_scene(args.rod_batch, cpu)
    rec = count(make_step_fn(cset, StepConfig(), cpu), state)
    print(json.dumps({"scene": f"rods x{args.rod_batch}",
                      "path": "rod_lattice" if cset.rod_lattices
                      else "unstructured", **rec}))
    for solver in ("tree", "dense"):
        state, cset = bt.tree_scene(args.tree_segments, cpu, solver=solver)
        db = cset.direct_rods[0]
        rec = count(make_step_fn(cset, StepConfig(), cpu), state)
        print(json.dumps({"scene": f"tree {args.tree_segments - 1}c",
                          "solver": solver, "levels": len(db.levels),
                          "constraints": int(db.edges.shape[0]), **rec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
