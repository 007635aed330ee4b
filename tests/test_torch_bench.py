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
     ("capacity_overflow",)),
    (["--rods", "--rod-batch", "8"], "cosserat_rods_x8_steps_per_s",
     ("aggregate_rod_steps_per_s",)),
    (["--tree", "--rod-batch", "8"], "stiff_rod_tree_7c_steps_per_s", ())],
    ids=["default", "batch", "mpc", "mpc_big", "bar", "fluid", "pile_big",
         "rods", "tree"])
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
    # bench.py names --pile-big's path by its broad phase, --rods' by the
    # lattice and --tree's by the scheduled elimination
    assert rec["path"].startswith("torch_") or (
        rec["path"] == "batched_broadphase" and "pile" in metric) or (
        rec["path"] == "rod_lattice" and "rods" in metric) or (
        rec["path"] == "tree_scheduled" and "tree" in metric)
    if "rods" in metric:
        assert rec["aggregate_rod_steps_per_s"] == pytest.approx(
            rec["value"] * 8, rel=1e-2)
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


@pytest.mark.parametrize("flags,names", [
    (["--check"], "no kernel"), (["--pile"], "PileScene.json"),
    (["--pile", "--scene", "absent/Scene.json"], "absent/Scene.json"),
    (["--armadillo-batch"], "ArmadilloCollisionScene.json"),
    (["--mpc-contact"], "ArmadilloCollisionScene.json")],
    ids=["--check-no kernel", "--pile-PileScene.json", "--scene-slice 8",
         "--armadillo-batch-ArmadilloCollisionScene.json",
         "--mpc-contact-slice 8"])
def test_check_on_cpu_and_unported_modes_exit_2(capsys, flags, names):
    """``--check`` on the CPU, and the scene-file modes without their file
    (the shipped scenes are not in the repository; ``--scene`` names
    another): exit 2, naming the missing file, with or without CUDA."""
    assert bench_torch.main(SMALL + flags) == 2
    out = capsys.readouterr()
    assert out.out == "" and names in out.err
    assert "slice" not in out.err
    if flags[0] != "--check":
        assert bench_torch.main(flags) == 2       # before the device check


def test_there_is_no_fuse_flag():
    """``--fuse`` is the default and ``--no-fuse`` turns it off, as in
    ``bench.py:660-664``; on the CPU both take the plain version."""
    assert bench_torch.parser().parse_args([]).fuse
    assert bench_torch.parser().parse_args(["--fuse"]).fuse
    assert not bench_torch.parser().parse_args(["--no-fuse"]).fuse
    for flag in ("--fuse", "--no-fuse"):
        code, (rec,) = bench_torch.run(SMALL + [flag])
        assert code == 0 and rec["path"] == "torch_plain"


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


def test_scene_takes_a_path():
    args = bench_torch.parser().parse_args(["--pile", "--scene", "a.json"])
    assert args.pile and args.scene == "a.json"
    args = bench_torch.parser().parse_args(["--armadillo-batch"])
    assert args.scene is None and bench_torch._scene_path(args) == \
        bench_torch.CONTACT_SCENE


def test_pile_on_the_stand_in(capsys, tmp_path):
    """``--pile --scene`` on the PileScene stand-in: its 34 bodies load as
    28 (6 of a missing mesh skipped, 2 dynamic) and the mode prints
    ``scene_PileScene_steps_per_s``."""
    path = bench_torch.write_pile_scene(str(tmp_path))
    with pytest.warns(UserWarning, match="missing geometry"):
        assert bench_torch.main(SMALL + ["--pile", "--scene", path]) == 0
    rec = json.loads(capsys.readouterr().out.strip())
    assert rec["metric"] == "scene_PileScene_steps_per_s"
    assert math.isfinite(rec["value"]) and rec["value"] > 0
    assert rec["path"] == "torch_rigid" and rec["capacity_overflow"] == 0.0
    with open(path) as f:
        assert len(json.load(f)["RigidBodies"]) == 34
    with pytest.warns(UserWarning):
        s = bench_torch.load_bench_scene(path, torch.device("cpu"))
    assert (len(s.rigid_ids), len(s.skipped_bodies)) == (28, 6)
    assert int((s.state.rigid.inv_mass > 0).sum()) == 2


@pytest.mark.parametrize("mode,metric", [
    (["--armadillo-batch", "--batch", "3"],
     "armadillo_batch3_steps_per_s_per_rollout"),
    (["--mpc-contact"] + MPC, "mppi_contact_scene_updates_per_s_k4_h5")],
    ids=["armadillo_batch", "mpc_contact"])
def test_contact_modes_on_a_tiny_stand_in(capsys, tmp_path, mode, metric):
    path = bench_torch.write_contact_scene(str(tmp_path), dims=(4, 2, 2))
    assert bench_torch.main(SMALL + mode + ["--scene", path]) == 0
    rec = json.loads(capsys.readouterr().out.strip())
    assert rec["metric"] == metric and rec["capacity_overflow"] == 0.0
    assert math.isfinite(rec["value"]) and rec["value"] > 0
    assert rec["aggregate_steps_per_s"] > 0 and rec["path"] == "torch_rigid"


def test_armadillo_batch_rollouts_equal_the_scene_alone(tmp_path):
    """Each rollout of the batch is the scene stepped alone."""
    path = bench_torch.write_contact_scene(str(tmp_path), dims=(4, 2, 2))
    cpu = torch.device("cpu")
    _, s, fn, batch = bench_torch.armadillo_batch(path, cpu, 2, 1, 3)
    st = s.state
    for _ in range(4):
        st = fn(st)
    for k in range(2):
        assert torch.equal(batch.particles.x[k], st.particles.x)


def test_stand_in_files_have_the_shipped_structure(tmp_path):
    """The contact stand-in's models are 20×8×8 tet grids (1,280 vertices,
    4,655 tets, close to the armadillo's 1,180 vertices), three of them
    with ``collisionObjectType`` 5; the cloth's plane is 51×51 vertices of
    quads with texture coordinates."""
    from positionbaseddynamics_tpu_torch.utils import load_obj, load_tetgen

    path = bench_torch.write_contact_scene(str(tmp_path))
    with open(path) as f:
        data = json.load(f)
    assert len(data["TetModels"]) == 3
    assert all(m["collisionObjectType"] == 5 for m in data["TetModels"])
    models = tmp_path / "models"
    verts, tets = load_tetgen(str(models / "bar.node"),
                              str(models / "bar.ele"))
    assert verts.shape == (1280, 3) and tets.shape == (4655, 4)
    bench_torch.write_cloth_scene(str(tmp_path))
    plane = load_obj(str(models / "plane.obj"))
    assert plane["vertices"].shape == (51 * 51, 3)
    assert plane["faces"].shape == (2 * 50 * 50, 3)
    assert plane["uv_indices"].shape == (2 * 50 * 50, 3)
    sphere = load_obj(str(models / "sphere.obj"))
    assert sphere["faces"].shape == (1280, 3)
