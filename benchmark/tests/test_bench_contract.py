"""BENCHMARK.json against the benchmark's contract, and the harness's
behaviour where it must refuse: no card, a checkout that holds only the
benchmark, and any module of JAX or of the JAX package loaded."""
import json
import os
import re
import shutil
import subprocess
import sys


from benchmark import spec

ROOT = spec.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "positionbaseddynamics_tpu"}


def test_benchmark_json_keeps_the_contract():
    b = spec.load()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    cells = {w["name"]: w for w in b["workloads"]}
    assert len(cells) == len(b["workloads"]) <= 24
    used = {w["config"] for w in b["workloads"]}
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
from benchmark.reference import grid_cloth, grid_tet, mppi
from benchmark.tests import tiny
cfg = tiny.config('cloth-320')
ref = grid_cloth.scene(cfg)
ref.step(ref.x0, torch.zeros_like(ref.x0))
grid_tet.scene(tiny.config('bar-80x36x36'))
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
