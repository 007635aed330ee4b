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
  drifts as a whole, cannot pass. A kind whose reference scene runs its
  own frames (``frame``) adds the numbers of its kind (``numbers``), such
  as the gap of a step it carries or a count of what the program dropped.
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


def run_frame(ref, inputs, start, steps) -> dict:
    """The reference's frame from a saved frame's inputs: ``x``, ``v``,
    ``old_x`` and ``last_x`` after ``steps`` steps, from the reference's
    own initial positions where the frame is the ``start``. A reference
    scene with a ``frame`` method (a kind whose step carries more than
    ``x`` and ``v``) runs the frame itself and adds what it carries."""
    if hasattr(ref, "frame"):
        return ref.frame(inputs, start, steps)
    x = ref.x0.expand_as(inputs["x"]) if start else inputs["x"]
    x, v = x.to(ref.dtype), inputs["v"].to(ref.dtype)
    for _ in range(steps):
        x, v, old, last = ref.step(x, v)
    return {"x": x, "v": v, "old_x": old, "last_x": last}


def sim_numbers(ref, samples, steps_per_frame) -> list:
    """One dict of numbers a saved frame; a reference scene with a
    ``numbers`` method adds the numbers of its kind."""
    out = []
    for s in samples:
        r = run_frame(ref, s["in"], s["start"], steps_per_frame)
        x, o = r["x"], s["out"]
        mean = (o["x"].to(x.device, torch.float64).mean(-2)
                - x.double().mean(-2))
        n = {"x_gap_m": max(_gap(o["x"], x), _gap(o["old_x"], r["old_x"]),
                            _gap(o["last_x"], r["last_x"])),
             "v_gap_mps": _gap(o["v"], r["v"]),
             "mean_gap_m": torch.linalg.vector_norm(mean, dim=-1).max().item()}
        if hasattr(ref, "numbers"):
            n.update(ref.numbers(o, r))
        out.append(n)
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
