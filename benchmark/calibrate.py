"""The readings a cell's limits are set from (not run by the benchmark's
own runs).

    python3 benchmark/calibrate.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--control] [--witness] [--fault <name>]

builds the cell's scene once and, for each seed, runs the cell's window
as a benchmark run does, saves the same periods, and reads the judge's
numbers of:

* ``program``: the program's outputs, as a run judges them; with
  ``--fault`` the program runs with that fault planted underneath
  (``FAULTS``);
* ``control`` (``--control``): the reference computed in bfloat16, the
  precision below the configuration's float32, in the program's place on
  the same inputs;
* ``witness`` (``--witness``): the reference computed in float64 in the
  program's place, which shows how far float32 itself spreads on those
  inputs.

Prints one JSON line a seed: each kind's largest reading of each number,
and the readings of each saved period.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0] = str(ROOT)

from benchmark import judge  # noqa: E402
from benchmark.controls import HandleVelocity  # noqa: E402


class FirstRolloutHandle(HandleVelocity):
    """A fault of the MPPI cells: every rollout's handle moved by rollout
    0's command."""

    def apply(self, state, u, dt):
        if u.dim() == 2:
            u = u[:1].expand_as(u)
        return super().apply(state, u, dt)


FAULTS = {"first_rollout_handle": FirstRolloutHandle}


def stand_in(config, mix, samples, ref) -> list:
    """The samples with their outputs made by the reference ``ref`` (of
    another precision) from the same inputs, in the program's place. Of an
    MPPI period's rollouts it runs the sample the judge reads; the others
    take an infinite cost, no weight in the nominal."""
    out = []
    for s in samples:
        i, o = s["in"], {}
        if mix["loop"] == "mpc":
            sc = ref.scene
            x = sc.x0 if s["start"] else i["x"].to(sc.dtype)
            v = torch.zeros_like(sc.x0) if s["start"] else i["v"].to(sc.dtype)
            nominal, eps = (a.to(sc.dtype) for a in (i["nominal"], i["eps"]))
            sub = torch.as_tensor(s["rollouts"], device=sc.device)
            costs = torch.full(eps.shape[:1], float("inf"), dtype=sc.dtype,
                               device=sc.device)
            costs[sub], o["finals"] = ref.rollouts(x, v, (nominal + eps)[sub])
            o["costs"] = costs
            o["nominal"] = ref.weighted(nominal, eps, costs)
            o["x"], o["v"], o["old_x"], o["last_x"] = sc.step(
                ref.apply(x, o["nominal"][0]), v)
        else:
            o = judge.run_frame(ref, i, s["start"],
                                int(mix["steps_per_frame"]))
        out.append({**s, "out": o})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--witness", action="store_true")
    ap.add_argument("--fault", choices=sorted(FAULTS))
    args = ap.parse_args(argv)

    from benchmark import harness, loops, spec
    if not torch.cuda.is_available():
        harness.log("no CUDA card")
        return 2
    if args.fault:
        loops.HandleVelocity = FAULTS[args.fault]
    device = torch.device("cuda", 0)
    bench = spec.load(ROOT)
    cell = spec.cell(bench, args.workload)
    config, mix = spec.config_and_mix(bench, cell)
    ref_kind = spec.kind_module("reference", config["kind"])
    state, cset = spec.kind_module("scenes", config["kind"]).build(
        config, device)
    refs = {"program": torch.float32}
    if args.control:
        refs["control"] = torch.bfloat16
    if args.witness:
        refs["witness"] = torch.float64
    built = {k: harness.reference_for(config, mix, device, d, ref_kind)
             for k, d in refs.items()}
    for seed in args.seeds:
        loop = harness.make_loop(config, mix, state, cset, seed, device,
                                 ref_kind)
        loop.warm()
        c = mix["check"]
        win = loop.run(seconds=args.seconds,
                       check=loops.schedule(seed, c["gap"], c["max"], 7))
        line = {"seed": seed, "fault": args.fault,
                "periods": len(win.periods),
                "saved": sorted(s["index"] for s in win.samples)}
        with torch.no_grad():
            for k in refs:
                t0 = time.perf_counter()
                samples = (win.samples if k == "program" else stand_in(
                    config, mix, win.samples, built[k]))
                per = harness.numbers(config, mix, samples, built["program"])
                line[k] = {n: max(p[n] for p in per) for n in per[0]}
                line[k + "_each"] = per
                line[k + "_s"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del loop, win
    return 0


if __name__ == "__main__":
    sys.exit(main())
