"""``bench_torch.py``, the port's benchmark, on the CPU: each ported mode
prints one JSON line with ``bench.py``'s metric name and a finite value at
a small size (``--device cpu`` runs the plain versions); without CUDA and
without ``--device cpu`` it exits non-zero and prints no result; ``--check``
on the CPU and the modes the port lacks exit 2. Every option of
``bench.py`` is parsed and does what ``bench.py``'s does; the default run's
secondary lines are checked with the modes stood in by monkeypatch."""
import json
import math
import re
import subprocess
import sys
import time
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
    (["--no-secondary"], "xpbd_cloth_0k_steps_per_s", ()),
    (["--batch", "2", "--no-secondary"], "xpbd_cloth_0k_steps_per_s_b2",
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


def test_fuse_is_the_default_and_no_fuse_turns_it_off():
    """``--fuse`` is the default and ``--no-fuse`` turns it off, as in
    ``bench.py:660-664``; on the CPU both take the plain version."""
    assert bench_torch.parser().parse_args([]).fuse
    assert bench_torch.parser().parse_args(["--fuse"]).fuse
    assert not bench_torch.parser().parse_args(["--no-fuse"]).fuse
    for flag in ("--fuse", "--no-fuse"):
        code, (rec,) = bench_torch.run(SMALL + [flag, "--no-secondary"])
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


# ---------------------------------------------------------------------------
# bench.py's options
# ---------------------------------------------------------------------------


def _bench_py_options():
    """The option strings of ``bench.py``'s parser, read from its source
    (importing it would import JAX)."""
    text = (ROOT / "bench.py").read_text()
    return set(re.findall(r'add_argument\(\s*"(--[a-z-]+)"', text))


def test_every_bench_py_option_is_listed():
    ours = set(bench_torch.parser()._option_string_actions)
    theirs = _bench_py_options()
    assert len(theirs) >= 30 and "--no-secondary" in theirs
    assert theirs <= ours, sorted(theirs - ours)
    out = subprocess.run([sys.executable, "bench_torch.py", "--help"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0
    for opt in theirs:
        assert opt in out.stdout, opt


@pytest.mark.parametrize("argv,want", [
    ([], dict(max_iterations=1, pallas=None, timers=False, profile=None,
              donate=False, no_secondary=False)),
    (["--max-iterations", "3"], dict(max_iterations=3)),
    (["--pallas"], dict(pallas=True)),
    (["--no-pallas"], dict(pallas=False)),
    (["--timers", "--profile", "out/dir"], dict(timers=True,
                                                profile="out/dir")),
    (["--donate", "--no-secondary"], dict(donate=True, no_secondary=True))],
    ids=["defaults", "max_iterations", "pallas", "no_pallas",
         "timers_profile", "donate_no_secondary"])
def test_new_options_parse(argv, want):
    args = bench_torch.parser().parse_args(argv)
    for k, v in want.items():
        assert getattr(args, k) == v, k


BAR = ["--bar", "--bar-dims", "6", "4", "4"]


@pytest.mark.parametrize("mode,iters,metric", [
    (BAR, 2, "xpbd_fem_bar_0k_steps_per_s_it2"),
    (BAR, 1, "xpbd_fem_bar_0k_steps_per_s"),
    (BAR + ["--no-fuse"], 3, "xpbd_fem_bar_0k_steps_per_s_it3"),
    (["--no-secondary"], 2, "xpbd_cloth_0k_steps_per_s")],
    ids=["bar_it2", "bar_it1", "bar_no_fuse_it3", "cloth_it2"])
def test_max_iterations_names_the_bar_metric(mode, iters, metric):
    """The bar's kernel-route metric gains ``_it{N}`` past one iteration,
    as ``bench.py:553-556`` names it; the cloth's keeps its name."""
    code, (rec,) = bench_torch.run(SMALL + mode + ["--max-iterations",
                                                   str(iters)])
    assert code == 0 and rec["metric"] == metric
    assert math.isfinite(rec["value"]) and rec["value"] > 0


def test_max_iterations_reaches_the_step(monkeypatch):
    """``--max-iterations`` is the solver's: the bar's step is built with
    it, and so is the cloth's."""
    from positionbaseddynamics_tpu_torch.solver import grid_cloth_cuda as gcc
    from positionbaseddynamics_tpu_torch.solver import grid_tet_cuda as gtc

    seen = []
    for mod, name in ((gtc, "make_tet_step"), (gcc, "make_cloth_step")):
        real = getattr(mod, name)

        def spy(*a, _real=real, **kw):
            seen.append(kw["max_iterations"])
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, spy)
    bench_torch.run(SMALL + BAR + ["--max-iterations", "4"])
    bench_torch.run(SMALL + ["--no-secondary", "--max-iterations", "3"])
    assert seen == [4, 3]


@pytest.mark.parametrize("mode,metric", [
    (["--no-secondary"], "xpbd_cloth_0k_steps_per_s"),
    (["--no-secondary", "--batch", "2"], "xpbd_cloth_0k_steps_per_s_b2"),
    (BAR, "xpbd_fem_bar_0k_steps_per_s")],
    ids=["cloth", "cloth_batch", "bar"])
def test_no_pallas_runs_the_general_stepper(mode, metric):
    """``--no-pallas`` steps the scene through ``solver.rollout(...,
    kernels=False)``; its path is ``make_step_fn``'s name for that route,
    and at ``--batch`` 2 the rollouts are a leading axis."""
    code, (rec,) = bench_torch.run(SMALL + mode + ["--no-pallas"])
    assert code == 0 and rec["metric"] == metric
    assert rec["path"] == "torch_stencil"
    assert math.isfinite(rec["value"]) and rec["value"] > 0
    if "--batch" in mode:
        assert rec["aggregate_steps_per_s"] == pytest.approx(
            2 * rec["value"], rel=1e-2)


def test_no_pallas_route_equals_the_plain_kernel_route():
    """The general stepper and the kernel route's plain version step the
    bench cloth alike: two runs of the same steps land on the same
    positions within float32 noise of the two code paths."""
    from positionbaseddynamics_tpu_torch.solver import StepConfig, rollout

    cpu = torch.device("cpu")
    state, cset = bench_torch.cloth_scene(8, 8, cpu)
    cfg = StepConfig()
    general, _ = rollout(state, cset, cfg, 3, kernels=False)
    step = bench_torch.cloth_step_fn(cset.grid_cloths[0],
                                     state.particles.inv_mass, cfg, cpu,
                                     n_steps=3)
    x, _ = step(state.particles.x, state.particles.v)
    assert (general.particles.x - x).abs().max().item() <= 1e-6


def test_timers_report_on_stderr(capsys):
    assert bench_torch.main(SMALL + ["--no-secondary", "--no-pallas",
                                     "--timers"]) == 0
    out = capsys.readouterr()
    assert "---- average times ----" in out.err
    assert "simulation step" in out.err
    assert json.loads(out.out.strip())["path"] == "torch_stencil"


def test_profile_writes_a_trace_on_the_cpu(capsys, tmp_path):
    d = tmp_path / "trace"
    assert bench_torch.main(SMALL + ["--no-secondary", "--no-pallas",
                                     "--profile", str(d)]) == 0
    trace = d / bench_torch.TRACE_FILE
    assert trace.exists() and trace.stat().st_size > 0
    assert "traceEvents" in trace.read_text()
    assert str(trace) in capsys.readouterr().err


@pytest.mark.parametrize("route", [[], ["--no-pallas"]],
                         ids=["kernel_route", "no_pallas"])
def test_donate_warns_that_pytorch_has_no_donation(capsys, route):
    assert bench_torch.main(SMALL + ["--no-secondary", "--donate"]
                            + route) == 0
    assert "no buffer donation" in capsys.readouterr().err


@pytest.mark.parametrize("flag", ["--timers", "--profile"])
def test_kernel_route_warns_that_it_ignores(capsys, tmp_path, flag):
    """As ``bench.py:795-803``: the kernel route ignores ``--timers`` and
    ``--profile`` and says so; no trace is written."""
    argv = [flag] + ([str(tmp_path / "t")] if flag == "--profile" else [])
    assert bench_torch.main(SMALL + ["--no-secondary"] + argv) == 0
    err = capsys.readouterr().err
    assert f"{flag} is ignored on the kernel route" in err
    assert not (tmp_path / "t").exists()


# ---------------------------------------------------------------------------
# the default run's secondary lines (bench.py:694-731)
# ---------------------------------------------------------------------------


def _stand_in_modes(monkeypatch, calls, fail=()):
    """Stand the default run's modes in by functions that record their
    arguments and return a record (or raise, for the names in ``fail``)."""
    def make(name, metric):
        def fn(args, dev):
            calls.append((name, args))
            if name in fail:
                raise RuntimeError(f"{name} failed")
            return {"metric": metric, "value": 1.0}
        return fn

    for name, metric in (("bench_bar", "bar"), ("bench_fluid", "dam"),
                         ("bench_pile_big", "pile"),
                         ("bench_cloth", "headline")):
        monkeypatch.setattr(bench_torch, name, make(name, metric))

    def mpc_contact(path, dev, samples, horizon, n_calls):
        calls.append(("mpc_contact", (path, samples, horizon, n_calls)))
        return {"metric": "contact", "value": 1.0}, None

    monkeypatch.setattr(bench_torch, "mpc_contact", mpc_contact)


def test_secondary_lines_come_first_with_bench_py_overrides(monkeypatch):
    calls = []
    _stand_in_modes(monkeypatch, calls)
    code, records = bench_torch.run(SMALL)
    assert code == 0
    assert [c[0] for c in calls] == ["bench_bar", "bench_fluid",
                                     "bench_pile_big", "bench_cloth"]
    bar, dam, pile, cloth = (c[1] for c in calls)
    assert (bar.calls, bar.steps_per_call, bar.check, bar.pallas) == (
        2, 10, False, None)
    assert tuple(dam.fluid_dims) == (40, 25, 12)
    assert (dam.calls, dam.steps_per_call) == (2, 10)
    assert (pile.calls, pile.steps_per_call, pile.pile_bodies) == (2, 10,
                                                                  100)
    # the headline keeps the command line's own values
    assert (cloth.calls, cloth.steps_per_call) == (1, 2)
    names = [r["metric"] for r in records]
    assert names == ["bar", "dam", "pile",
                     "mppi_contact_scene_updates_per_s", "headline"]
    contact = records[3]
    assert "ArmadilloCollisionScene.json" in contact["error"]
    assert contact["error"].startswith("FileNotFoundError")


def test_secondary_contact_line_takes_the_scene(monkeypatch, tmp_path):
    calls = []
    _stand_in_modes(monkeypatch, calls)
    scene = tmp_path / "Contact.json"
    scene.write_text("{}")
    code, records = bench_torch.run(SMALL + ["--scene", str(scene)])
    assert code == 0
    assert ("mpc_contact", (str(scene), 128, 10, 1)) in calls
    assert [r["metric"] for r in records] == ["bar", "dam", "pile",
                                              "contact", "headline"]


def test_a_failing_secondary_becomes_an_error_line(monkeypatch, capsys):
    calls = []
    _stand_in_modes(monkeypatch, calls, fail=("bench_fluid",))
    assert bench_torch.main(SMALL) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[1] == {"metric": "pbf_dam_12k_steps_per_s",
                        "error": "RuntimeError: bench_fluid failed"}
    assert lines[-1]["metric"] == "headline" and len(lines) == 5


def test_a_secondary_past_its_watchdog_is_cut(monkeypatch):
    calls = []
    _stand_in_modes(monkeypatch, calls)
    monkeypatch.setattr(bench_torch, "SECONDARY_EACH_S", 1)

    def slow(args, dev):
        time.sleep(5)
        return {"metric": "pile", "value": 1.0}

    monkeypatch.setattr(bench_torch, "bench_pile_big", slow)
    t0 = time.perf_counter()
    _, records = bench_torch.run(SMALL)
    assert time.perf_counter() - t0 < 4
    assert records[2] == {"metric": "rigid_pile_100body_steps_per_s",
                          "error": "TimeoutError: rigid_pile_100body_steps_"
                                   "per_s exceeded 1s"}
    assert records[-1]["metric"] == "headline"


def test_a_spent_budget_skips_the_secondaries(monkeypatch):
    calls = []
    _stand_in_modes(monkeypatch, calls)
    monkeypatch.setattr(bench_torch, "SECONDARY_BUDGET_S", 10.0)
    _, records = bench_torch.run(SMALL)
    assert [c[0] for c in calls] == ["bench_cloth"]
    assert all(r["error"] == "skipped: secondary budget exhausted"
               for r in records[:4])
    assert records[-1]["metric"] == "headline"


@pytest.mark.parametrize("flag", ["--no-secondary", "--bar"])
def test_no_secondary_lines_outside_the_default_run(monkeypatch, flag):
    calls = []
    _stand_in_modes(monkeypatch, calls)
    code, records = bench_torch.run(SMALL + [flag])
    assert code == 0 and len(records) == 1
    assert len(calls) == 1


def test_kernels_false_keeps_a_kernel_scene_off_the_kernel(monkeypatch):
    """``make_step_fn`` takes the kernel plan where one exists, and
    ``kernels=False`` (``--no-pallas``) keeps the scene on the PyTorch
    route; the plan is stood in here, since on the CPU there is none."""
    import importlib

    from positionbaseddynamics_tpu_torch.solver import StepConfig, make_step_fn

    # the package exports the function step; the module is the stepper's
    step_mod = importlib.import_module(
        "positionbaseddynamics_tpu_torch.solver.step")

    runs = []

    def run(p, n):
        runs.append(n)
        return p.x, p.v, p.x, None

    monkeypatch.setattr(step_mod, "kernel_plan",
                        lambda cset, cfg: step_mod.KernelPlan("cloth", run))
    cpu = torch.device("cpu")
    state, cset = bench_torch.cloth_scene(6, 6, cpu)
    cfg = StepConfig()
    kernel = make_step_fn(cset, cfg, cpu)
    general = make_step_fn(cset, cfg, cpu, kernels=False)
    assert (kernel.path, general.path) == ("cuda_kernel", "torch_stencil")
    kernel(state)
    assert runs == [cfg.substeps]
    moved = general(state)
    assert runs == [cfg.substeps]
    assert not torch.equal(moved.particles.x, state.particles.x)
