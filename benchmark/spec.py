"""Where the harness finds what ``BENCHMARK.json`` names, by name alone:

* a configuration: the ``file`` its entry gives, and its ``kind``'s
  modules ``benchmark/scenes/<kind>.py`` (the program's build, and where
  the kind is not stepped by ``make_step_fn`` a ``Drive`` that steps it
  through its own entry point, as ``loops.ParticleDrive`` does through
  ``make_step_fn``), ``benchmark/reference/<kind>.py`` (the plain
  reference; a scene with a ``frame`` method runs the frames of a kind
  that carries more state than ``x`` and ``v``, and adds its numbers) and
  ``benchmark/work/<kind>.py`` (the work counts);
* a traffic mix: ``benchmark/traffic/<mix>.json``, read by the one
  generator in ``benchmark/loops.py``;
* a per-layer metric: its reader ``benchmark/metrics/<metric>.py``.

A cell made of files that are there, with a new ``workloads`` entry,
runs without an edit to any of them; so does a new kind, sim cells of a
kind with its own stepper included, made of new files alone. (The MPPI
loop plans over ``make_step_fn``'s scenes only.)
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                   + ", ".join(w["name"] for w in bench["workloads"]))


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def mix(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def config_and_mix(bench: dict, cell: dict):
    """A cell's configuration and mix, the configuration's ``step``
    updated by the mix's own ``step`` settings, if any, so that the
    program and the reference run the same step."""
    c, m = config(bench, cell["config"]), mix(cell["traffic"])
    return {**c, "step": {**c["step"], **m.get("step", {})}}, m


def kind_module(part: str, kind: str):
    """``benchmark/<part>/<kind>.py`` (``scenes``, ``reference``,
    ``work``)."""
    return importlib.import_module(f"benchmark.{part}.{kind}")


def reader(metric: str):
    """The reader module ``benchmark/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def end_to_end(bench: dict, cell_name: str) -> list:
    """The end-to-end metrics a cell reports."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell_name in m["workloads"]]


def per_layer(bench: dict, cell_name: str) -> list:
    """The per-layer metrics read in a cell's traced run: those that list
    it, and those without a list whose end-to-end metric it reports."""
    e2e = {m["name"] for m in end_to_end(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]
