"""The cells at sizes a CPU test run holds: every configuration and mix
as the files give them, with the sizes, the rollouts and the periods cut.
The limits stay the configurations' own."""
from __future__ import annotations

from benchmark import spec

_config, _mix = spec.config, spec.mix

TINY = {
    "grid_cloth": dict(width=12, height=10, pinned=[0, 11]),
    "grid_tet": dict(width=6, height=4, depth=3),
}


def config(name: str) -> dict:
    c = _config(spec.load(), name)
    c.update(TINY[c["kind"]])
    # vertices a few cells from the handle, as the configurations track
    if c["kind"] == "grid_cloth":
        c["mpc"]["tracked"] = [i * c["width"] + j
                               for i in (1, 2, 4) for j in (1, 2, 4)]
    else:
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
    """Make ``spec`` hand the harness the tiny configurations and mixes."""
    monkeypatch.setattr(spec, "config", lambda bench, name, root=None:
                        config(name))
    monkeypatch.setattr(spec, "mix", mix)


CELLS = ["cloth-320.mpc-k256", "cloth-320.sim-1", "bar-80x36x36.mpc-k256",
         "bar-80x36x36.sim-1"]
