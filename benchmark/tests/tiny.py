"""The cells at sizes a CPU test run holds: every configuration and mix
as the files give them, with the sizes, the rollouts and the periods cut.
The limits stay the configurations' own. The cells held outside
``BENCHMARK.json`` (``held.json``: what each waits for, and the entries
it takes then) run here beside the others."""
from __future__ import annotations

import json

from benchmark import spec

_config, _mix, _load = spec.config, spec.mix, spec.load
HELD = spec.HERE / "tests" / "held.json"


def load(root=spec.ROOT) -> dict:
    """``BENCHMARK.json`` with the held cells' entries in: each
    configuration, cell, end-to-end and per-layer metric of ``held.json``
    whose name ``BENCHMARK.json`` has not, and each cell of ``also_in``
    that its metric does not list yet. A held cell admitted by copying its
    entries into ``BENCHMARK.json`` is so listed once."""
    bench, held = _load(root), json.loads(HELD.read_text())
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        have = {e["name"] for e in bench[part]}
        bench[part] += [e for e in held[part] if e["name"] not in have]
    for m in bench["end_to_end"] + bench["per_layer"]:
        listed = m.get("workloads", [])
        m["workloads"] = listed + [w for w in held["also_in"].get(
            m["name"], []) if w not in listed]
        if not m["workloads"]:
            del m["workloads"]
    return bench

TINY = {
    "grid_cloth": dict(width=12, height=10, pinned=[0, 11]),
    "grid_tet": dict(width=6, height=4, depth=3),
    "pbf_dam": dict(block=[8, 6, 4], box_spacings=[40, 16, 6]),
}


def config(name: str) -> dict:
    c = _config(load(), name)
    c.update(TINY[c["kind"]])
    # vertices a few cells from the handle, as the configurations track
    if c["kind"] == "grid_cloth":
        c["mpc"]["tracked"] = [i * c["width"] + j
                               for i in (1, 2, 4) for j in (1, 2, 4)]
    elif c["kind"] == "grid_tet":
        hd = c["height"] * c["depth"]
        c["mpc"]["tracked"] = [i * hd + jk for i in (1, 2, 4)
                               for jk in (0, hd // 2, hd - 1)]
    return c


def mix(name: str) -> dict:
    m = _mix(name)
    if m["loop"] == "mpc":
        m.update(num_samples=8, horizon=3, warm_periods=1)
        m["check"] = {"gap": 2, "max": 3, "rollouts": 4}
        m["trace"] = {"count": 3, "check_gap": 1, "check_max": 2}
    else:
        m.update(warm_frames=1)
        m["check"] = {"gap": 2, "max": 3}
        m["trace"] = {"count": 3, "check_gap": 1, "check_max": 2}
    return m


def patch(monkeypatch):
    """Make ``spec`` hand the harness the tiny configurations and mixes,
    and the held cells beside the others."""
    monkeypatch.setattr(spec, "load", lambda root=spec.ROOT: load(root))
    monkeypatch.setattr(spec, "config", lambda bench, name, root=None:
                        config(name))
    monkeypatch.setattr(spec, "mix", mix)


CELLS = ["cloth-320.mpc-k256", "cloth-320.sim-1", "bar-80x36x36.mpc-k256",
         "bar-80x36x36.sim-1", "dam-100k.sim-1"]
