"""Run one benchmark cell once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``,
each number the judge compared beside its limit (also the last lines of
standard error). Without a CUDA card, with fewer cards than the cell
asks for, or if JAX, Flax or the JAX package has been loaded, it exits
with a code other than 0 and prints no result.

The process computes on the host with one thread: the load comes from
one process with few threads, so that host-bound cells spread less.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402

for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi unavailable ({e})"
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness, spec

    bench = spec.load(ROOT)
    cell = spec.cell(bench, args.workload)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        harness.log("no CUDA card: the benchmark measures the card only")
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        harness.log(f"{args.workload} needs {cell['chips']} cards; "
                    f"{torch.cuda.device_count()} present")
        return 2
    device = torch.device("cuda", 0)
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), device, T_START)
    found = harness.forbidden_modules()
    if found:
        harness.log("refused: loaded modules " + ", ".join(found))
        return 3
    harness.log(f"card: {card_line()}")
    print(json.dumps(result), flush=True)
    for k, c in result["checks"].items():
        harness.log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
