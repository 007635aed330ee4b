"""``bench_torch.py``, the port's benchmark, on the CPU: each ported mode
prints one JSON line with ``bench.py``'s metric name and a finite value at
a small size (``--device cpu`` runs the plain versions); without CUDA and
without ``--device cpu`` it exits non-zero and prints no result; ``--check``
on the CPU and the modes the port lacks exit 2."""
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import bench_torch

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--device", "cpu", "--width", "16", "--height", "16", "--calls",
         "1", "--steps-per-call", "2"]
MPC = ["--mpc-samples", "4", "--mpc-horizon", "2"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode,metric,extra", [
    ([], "xpbd_cloth_0k_steps_per_s", ()),
    (["--batch", "2"], "xpbd_cloth_0k_steps_per_s_b2",
     ("aggregate_steps_per_s",)),
    (["--mpc"] + MPC, "mppi_cloth1k_rollouts_per_s_k4_h2", ()),
    (["--mpc-big"] + MPC, "mppi_cloth0k_planner_updates_per_s_k4_h2",
     ("aggregate_steps_per_s",)),
    (["--bar", "--bar-dims", "6", "4", "4"], "xpbd_fem_bar_0k_steps_per_s",
     ()),
    (["--fluid", "--fluid-dims", "6", "8", "6"], "pbf_dam_0k_steps_per_s",
     ("capacity_overflow", "n_fluid", "n_boundary")),
    (["--pile-big", "--pile-bodies", "4"], "rigid_pile_4body_steps_per_s",
     ("capacity_overflow",))],
    ids=["default", "batch", "mpc", "mpc_big", "bar", "fluid", "pile_big"])
def test_mode_prints_one_line_with_the_bench_metric(capsys, mode, metric,
                                                    extra):
    assert bench_torch.main(SMALL + mode) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == metric
    assert math.isfinite(rec["value"]) and rec["value"] > 0
    # vs_baseline is the rate over 60, --mpc-big's rate its rollout-steps/s
    # (bench.py:142); each number is rounded as bench.py rounds it
    per_s, unit = ((rec["aggregate_steps_per_s"], 0.1)
                   if "planner_updates" in metric else (rec["value"], 0.01))
    assert abs(rec["vs_baseline"] - per_s / 60.0) <= 5e-4 + unit / 120 + 1e-9
    for k in ("unit", "path", "device", "card") + extra:
        assert k in rec, k
    assert rec["device"] == "cpu" and rec["card"] is None
    # bench.py names --pile-big's path by its broad phase
    assert rec["path"].startswith("torch_") or (
        rec["path"] == "batched_broadphase" and "pile" in metric)
    if "capacity_overflow" in extra:
        assert rec["capacity_overflow"] == 0.0


def test_without_cuda_it_exits_non_zero_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run(
        [sys.executable, "bench_torch.py", "--width", "16", "--height",
         "16", "--calls", "1", "--steps-per-call", "2"], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA is not available" in out.stderr


@pytest.mark.parametrize("flag,names", [
    ("--check", "no kernel"), ("--pile", "PileScene.json"),
    ("--scene", "slice 8"), ("--rods", "slice 7"), ("--tree", "slice 7"),
    ("--armadillo-batch", "ArmadilloCollisionScene.json"),
    ("--mpc-contact", "slice 8")])
def test_check_on_cpu_and_unported_modes_exit_2(capsys, flag, names):
    assert bench_torch.main(SMALL + [flag]) == 2
    out = capsys.readouterr()
    assert out.out == "" and names in out.err


def test_there_is_no_fuse_flag():
    with pytest.raises(SystemExit):
        bench_torch.parser().parse_args(["--fuse"])


def test_mpc_big_update_at_one_rollout_leaves_the_start_state_alone():
    """At K 1 the rollouts' start state is still a copy: the pin's update
    writes in place and must not reach the planner's start state, so two
    updates with the same noise give the same result."""
    planner = bench_torch.MpcBig(8, 1, 2, torch.device("cpu"))
    x0 = planner.x0.clone()
    eps = planner.draw(torch.Generator().manual_seed(0))
    nominal = torch.zeros((2, 3))
    first = planner.update(nominal, eps)
    second = planner.update(nominal, eps)
    assert torch.equal(planner.x0, x0)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
