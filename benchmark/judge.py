"""How ``correct`` is decided: the outputs the timed path produced at the
saved periods, held against the plain reference run from the same
inputs, each number against its limit from the configuration's
``limits`` for the loop's kind.

The reference follows the program from the program's own state at each
saved period; the first period (index 0) it runs from its own initial
state, worked out from the configuration, so that the scene build and
the start are checked too.

* ``sim``: each saved frame's ``steps_per_frame`` steps. ``x_gap_m`` is
  the largest distance, over the frame's final positions (the host copy)
  and the step route's ``old_x`` and ``last_x``, from the reference's;
  ``v_gap_mps`` the same of the velocities; ``mean_gap_m`` the distance
  of the particles' mean final position from the reference's, a steady
  number that rounding hardly moves and a scene that stands still, or
  drifts as a whole, cannot pass.
* ``mpc``: each saved period. ``cost_gap`` is the largest gap of a
  rollout's cost from the reference's, over the median reference cost,
  on a sample of the rollouts drawn from the seed (the first and the last
  always among them); ``rollout_gap_m`` the largest gap of those
  rollouts' final positions, over every particle; ``nominal_gap_mps`` the largest gap of the updated
  nominal from the reference's softmin update of the program's costs,
  which judges that stage alone, the costs being judged on the sample;
  ``state_gap_m`` the largest gap of the executed step's positions,
  ``old_x`` and ``last_x``, stepped by the reference from the same state
  under the program's first command.
"""
from __future__ import annotations

import torch


def _gap(a, b) -> float:
    return (a.to(b.device, torch.float64) - b.double()).abs().max().item()


def sim_numbers(ref, samples, steps_per_frame) -> list:
    """One dict of numbers a saved frame."""
    out = []
    for s in samples:
        x = ref.x0.expand_as(s["in"]["x"]) if s["start"] else s["in"]["x"]
        x, v = x.to(ref.dtype), s["in"]["v"].to(ref.dtype)
        for _ in range(steps_per_frame):
            x, v, old, last = ref.step(x, v)
        o = s["out"]
        mean = (o["x"].to(x.device, torch.float64).mean(-2)
                - x.double().mean(-2))
        out.append({
            "x_gap_m": max(_gap(o["x"], x), _gap(o["old_x"], old),
                           _gap(o["last_x"], last)),
            "v_gap_mps": _gap(o["v"], v),
            "mean_gap_m": torch.linalg.vector_norm(mean, dim=-1).max().item()})
    return out


def mpc_numbers(planner, samples) -> list:
    """One dict of numbers a saved period."""
    ref = planner.scene
    out = []
    for s in samples:
        i = s["in"]
        x = ref.x0 if s["start"] else i["x"].to(ref.dtype)
        v = (torch.zeros_like(ref.x0) if s["start"]
             else i["v"].to(ref.dtype))
        o = s["out"]
        sub = torch.as_tensor(s["rollouts"], device=ref.device)
        costs, finals = planner.rollouts(x, v,
                                         (i["nominal"] + i["eps"])[sub])
        scale = costs.double().abs().median().item()
        nominal = planner.weighted(i["nominal"].double(), i["eps"].double(),
                                   o["costs"].double())
        xs, _v, old, last = ref.step(planner.apply(x, o["nominal"][0]), v)
        out.append({
            "cost_gap": _gap(o["costs"][sub], costs) / scale,
            "rollout_gap_m": _gap(o["finals"], finals),
            "nominal_gap_mps": _gap(o["nominal"], nominal),
            "state_gap_m": max(_gap(o["x"], xs), _gap(o["old_x"], old),
                               _gap(o["last_x"], last))})
    return out


def verdict(per_sample: list, limits: dict):
    """``(correct, failed samples, {number: {"value", "limit"}})``: each
    number's largest reading over the samples beside its limit."""
    def bad(v, k):
        return not v <= limits[k]          # NaN is bad too

    failed = sum(any(bad(n[k], k) for k in limits) for n in per_sample)
    checks = {}
    for k in limits:
        vals = [n[k] for n in per_sample]
        nan = any(v != v for v in vals)
        checks[k] = {"value": None if nan or not vals else max(vals),
                     "limit": limits[k]}
    correct = bool(per_sample) and failed == 0
    return correct, failed, checks
