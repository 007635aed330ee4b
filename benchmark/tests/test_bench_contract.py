"""BENCHMARK.json against the benchmark's contract, and the harness's
behaviour where it must refuse: no card, a checkout that holds only the
benchmark, and any module of JAX or of the JAX package loaded."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import spec
from benchmark.tests import tiny

ROOT = spec.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "positionbaseddynamics_tpu"}
PROGRAM = "positionbaseddynamics_tpu_torch"


@pytest.mark.parametrize("load", [spec.load, tiny.load],
                         ids=["benchmark", "with_the_held_cells"])
def test_benchmark_json_keeps_the_contract(load):
    b = load()
    _keeps_the_contract(b)
    _holds_the_held_entries(b)


def _keeps_the_contract(b: dict):
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    cells = {w["name"]: w for w in b["workloads"]}
    assert len(cells) == len(b["workloads"]) <= 24
    used = {w["config"] for w in b["workloads"]}
    assert len({c["name"] for c in b["configs"]}) == len(b["configs"])
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert c["file"].startswith("benchmark/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        assert (spec.HERE / "scenes" / f"{cfg['kind']}.py").exists()
        assert (spec.HERE / "reference" / f"{cfg['kind']}.py").exists()
        assert (spec.HERE / "work" / f"{cfg['kind']}.py").exists()
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (spec.HERE / "traffic" / f"{w['traffic']}.json").exists()
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in \
        e2e["setup_s"]
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(cells)
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert (spec.HERE / "metrics" / f"{m['name']}.py").exists()
        for w in m["workloads"]:
            assert m["moves"] in {x["name"] for x in spec.end_to_end(b, w)}
    for w in cells:
        e = {m["name"] for m in spec.end_to_end(b, w)}
        assert "setup_s" in e and len(e) >= 2
        assert spec.per_layer(b, w)
    assert len(json.dumps(b)) < 64 * 1024


def _admitted(root):
    """``BENCHMARK.json`` under ``root`` with ``held.json``'s entries
    copied in, as the change that admits the held cells writes it."""
    (root / "BENCHMARK.json").write_text(json.dumps(tiny.load(), indent=1))
    return root


def _holds_the_held_entries(b: dict):
    """A held cell that ``b`` has comes with ``held.json``'s entries as they
    are there: its cell, its configuration, its end-to-end and per-layer
    metrics, and its name in each metric of ``also_in``."""
    held = json.loads(tiny.HELD.read_text())
    by_name = {p: {e["name"]: e for e in b[p]}
               for p in ("configs", "workloads", "end_to_end", "per_layer")}
    for w in held["workloads"]:
        if w["name"] not in by_name["workloads"]:
            continue
        assert by_name["workloads"][w["name"]] == w
        c = next(c for c in held["configs"] if c["name"] == w["config"])
        assert by_name["configs"].get(c["name"]) == c
        for part in ("end_to_end", "per_layer"):
            for m in held[part]:
                if w["name"] in m["workloads"]:
                    assert by_name[part].get(m["name"]) == m
        metrics = {**by_name["end_to_end"], **by_name["per_layer"]}
        for name, cells in held["also_in"].items():
            if w["name"] in cells:
                assert w["name"] in metrics[name]["workloads"], name


def test_held_cells_enter_by_their_entries_alone(tmp_path):
    """With ``held.json``'s entries copied into ``BENCHMARK.json`` and no
    other file edited, both loads keep the contract, list each name once,
    hold the held entries as ``held.json`` gives them, and agree: nothing
    is left for ``tiny.load`` to add."""
    root = _admitted(tmp_path)
    for load in (spec.load, tiny.load):
        b = load(root)
        _keeps_the_contract(b)
        _holds_the_held_entries(b)
        for part in ("configs", "workloads"):
            names = [e["name"] for e in b[part]]
            assert len(set(names)) == len(names), part
        for m in b["end_to_end"] + b["per_layer"]:
            assert len(set(m.get("workloads", []))) == \
                len(m.get("workloads", [])), m["name"]
    assert tiny.load(root) == spec.load(root)
    assert {w["name"] for w in spec.load(root)["workloads"]} == \
        set(tiny.CELLS)


def test_a_held_cell_admitted_with_other_entries_is_refused(tmp_path):
    root, held = _admitted(tmp_path), json.loads(tiny.HELD.read_text())
    for part, key in (("workloads", "why"), ("configs", "source"),
                      ("end_to_end", "bound"), ("per_layer", "layer")):
        b = spec.load(root)
        e = next(e for e in b[part] if e["name"] == held[part][0]["name"])
        e[key] = "changed"
        with pytest.raises(AssertionError):
            _holds_the_held_entries(b)
    b = spec.load(root)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    e2e["sim_frame_p95_ms"]["workloads"].remove("dam-100k.sim-1")
    with pytest.raises(AssertionError):
        _holds_the_held_entries(b)


# A per-layer metric that the change admitting the held cell might bring:
# a reader of a span of the fluid step's own, as a new file
STUB = {"name": "pbf_wrapper_host_us.sim", "unit": "us", "better": "lower",
        "source": "program_span", "layer": "kernel wrapper",
        "moves": "sim_steps_per_s", "workloads": ["dam-100k.sim-1"]}
STUB_READER = '''"""Host us a step inside the fluid wrapper's span."""


def read(run):
    t = run.trace
    if run.loop != "sim" or t is None or not run.window.steps:
        return None
    inside = t.span_intervals("pbd.kernel.pbf_density_lambda")
    if not inside:
        return None
    return sum(b - a for a, b in inside) / run.window.steps
'''


def test_a_held_cell_and_a_new_reader_need_no_other_edit(tmp_path):
    """A copy of the benchmark with ``held.json``'s entries in
    ``BENCHMARK.json`` and a new per-layer metric of the held cell, its
    reader a new file and its entry appended: the tests that read
    ``BENCHMARK.json`` and the readers as a whole pass there, and so does
    the held cell's traced run, with no other file of the benchmark
    edited."""
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / PROGRAM).symlink_to(ROOT / PROGRAM)
    b = spec.load(_admitted(tmp_path))
    b["per_layer"].append(STUB)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b, indent=1))
    (tmp_path / "benchmark" / "metrics" / f"{STUB['name']}.py").write_text(
        STUB_READER)
    p = _run(["-m", "pytest", "-q", "-p", "no:cacheprovider",
              "-k", "not need_no_other_edit",
              "benchmark/tests/test_bench_contract.py",
              "benchmark/tests/test_bench_spans.py",
              "benchmark/tests/test_bench_harness.py::"
              "test_sound_runs_are_correct[dam-100k.sim-1-True]"], tmp_path)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    assert " passed" in p.stdout and "skipped" not in p.stdout


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, **(env or {})})


def test_without_a_card_run_exits_nonzero_and_prints_no_result():
    p = _run(["benchmark/run.py", "--workload", "cloth-320.sim-1",
              "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"],
             ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_a_checkout_of_the_benchmark_alone_refuses(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time, torch; sys.path[0] = '.'; "
            "from benchmark import harness, spec; "
            "harness.run_cell(spec.load(), 'cloth-320.sim-1', 1, 1.0, False,"
            " torch.device('cpu'), time.perf_counter())")
    p = _run(["-c", code], tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "positionbaseddynamics_tpu_torch" in p.stderr
    p = _run(["benchmark/run.py", "--workload", "cloth-320.sim-1", "--seed",
              "3", "--seconds", "1"], tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_the_harness_loads_nothing_of_jax():
    """The harness's pieces in a fresh process, at tiny sizes on the CPU:
    no loaded module's top-level name is JAX's, Flax's or the JAX
    package's, and the reference alone loads nothing of the program."""
    code = """
import sys, time, json, torch
sys.path[0] = %r
from benchmark.reference import grid_cloth, grid_tet, mppi, pbf_dam
from benchmark.tests import tiny
cfg = tiny.config('cloth-320')
ref = grid_cloth.scene(cfg)
ref.step(ref.x0, torch.zeros_like(ref.x0))
grid_tet.scene(tiny.config('bar-80x36x36'))
dam = pbf_dam.scene(tiny.config('dam-100k'))
dam.step(dam.x0, torch.zeros_like(dam.x0), dam.dt0)
before = sorted({m.split('.')[0] for m in sys.modules})
from benchmark import harness, spec, trace, judge, loops
class MP:
    def setattr(self, o, n, v): setattr(o, n, v)
tiny.patch(MP())
r = harness.run_cell(spec.load(), 'bar-80x36x36.mpc-k256', 5, 0.3, True,
                     torch.device('cpu'), time.perf_counter())
assert list(r)[-1] == 'checks'
print(json.dumps({'before': before,
                  'after': sorted({m.split('.')[0] for m in sys.modules}),
                  'forbidden': harness.forbidden_modules()}))
""" % str(ROOT)
    p = _run(["-c", code], ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["forbidden"] == []
    assert not set(out["after"]) & FORBIDDEN
    assert "positionbaseddynamics_tpu_torch" not in out["before"]
    assert "positionbaseddynamics_tpu_torch" in out["after"]


def test_forbidden_names_are_compared_whole(monkeypatch):
    from benchmark import harness

    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    monkeypatch.setitem(sys.modules, "positionbaseddynamics_tpu_torchx", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


HARNESS = ("run.py", "harness.py", "loops.py", "judge.py", "spec.py",
           "calibrate.py", "trace.py", "controls.py")


def test_no_harness_file_names_a_kind():
    """A kind is found by its name in its configuration alone: the files
    every cell runs through name none, so that a new kind needs no edit
    of them."""
    kinds = {json.loads((ROOT / c["file"]).read_text())["kind"]
             for c in tiny.load()["configs"]}
    for name in HARNESS:
        text = (spec.HERE / name).read_text()
        for k in kinds:
            assert k not in text, (name, k)


def test_each_kind_brings_what_its_cells_need():
    b = tiny.load()
    drive_parts = ("entry", "substeps", "judges_last", "positions", "free",
                   "start", "save_in", "save_out")
    for c in b["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
        scenes = spec.kind_module("scenes", cfg["kind"])
        drive = getattr(scenes, "Drive", None)
        loops_of = {spec.mix(w["traffic"])["loop"] for w in b["workloads"]
                    if w["config"] == c["name"]}
        assert set(cfg["limits"]) >= loops_of
        if drive is None:
            continue
        for part in drive_parts:
            assert hasattr(drive, part), (cfg["kind"], part)
        # a kind with its own stepper runs sim cells and its reference
        # runs the frames, with a number for each that it adds
        assert loops_of == {"sim"}
        ref = spec.kind_module("reference", cfg["kind"])
        assert any(hasattr(v, "frame") and hasattr(v, "numbers")
                   for v in vars(ref).values() if isinstance(v, type))
    dam = json.loads((ROOT / "benchmark/configs/dam-100k.json").read_text())
    assert dam["limits"]["sim"]["overflow"] == 0
    assert {"x_gap_m", "v_gap_mps", "mean_gap_m"} <= set(dam["limits"]["sim"])
