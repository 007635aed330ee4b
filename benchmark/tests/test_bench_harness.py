"""Whole runs of each cell on the CPU at tiny sizes, through the
harness's own path with the look for a card skipped: sound runs come
out correct, and runs with the timed path broken underneath, or with the
reference in bfloat16 in the program's place (the control), come out
not correct at the configurations' own limits."""
import importlib
import time

import pytest
import torch

from benchmark import harness, spec
from benchmark.tests import tiny

CPU = torch.device("cpu")
SEED = 2**31 + 12345


def _run(monkeypatch, cell, trace=False, seconds=0.4, bench=None):
    tiny.patch(monkeypatch)
    return harness.run_cell(bench or spec.load(), cell, SEED, seconds, trace,
                            CPU, time.perf_counter())


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", tiny.CELLS)
def test_sound_runs_are_correct(monkeypatch, cell, trace):
    r = _run(monkeypatch, cell, trace)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    bench = spec.load()
    want = (spec.per_layer if trace else spec.end_to_end)(bench, cell)
    if not trace:
        assert set(r["metrics"]) == {m["name"] for m in want}
    else:
        assert "scene_build_s" in r["metrics"]
        assert r["device"]["window_s"] > 0
    for m in r["metrics"].values():
        assert m["value"] > 0


def _step_module():
    return importlib.import_module(
        "positionbaseddynamics_tpu_torch.solver.step")


def _unchanged(monkeypatch):
    monkeypatch.setattr(_step_module(), "step",
                        lambda state, *a, **k: state)


def _altered(monkeypatch):
    import dataclasses
    orig = _step_module().step

    def step(state, *a, **k):
        s = orig(state, *a, **k)
        p = s.particles
        x = p.x.clone()
        x[..., 7, 1] += 0.1
        return dataclasses.replace(s, particles=dataclasses.replace(p, x=x))

    monkeypatch.setattr(_step_module(), "step", step)


def _half_batch(monkeypatch):
    from positionbaseddynamics_tpu_torch import mpc

    def update(state, nominal, seq_cost, mcfg, generator=None, eps=None):
        costs = seq_cost(state, nominal + eps)[0]
        k = costs.shape[0] // 2
        c = costs[:k]
        w = torch.exp(-(c - c.min()) / mcfg.temperature)
        w = w / w.sum()
        return nominal + torch.tensordot(w, eps[:k], dims=1), costs

    monkeypatch.setattr(mpc, "mppi_update", update)


def _first_rollout_handle(monkeypatch):
    from benchmark import calibrate, loops

    monkeypatch.setattr(loops, "HandleVelocity",
                        calibrate.FAULTS["first_rollout_handle"])


def _last_rollout_altered(monkeypatch):
    import dataclasses
    orig = _step_module().step

    def step(state, *a, **k):
        s = orig(state, *a, **k)
        p = s.particles
        if p.x.dim() < 3:
            return s
        x = p.x.clone()
        x[-1, -1, 1] += 0.01
        return dataclasses.replace(s, particles=dataclasses.replace(p, x=x))

    monkeypatch.setattr(_step_module(), "step", step)


def _command_altered(monkeypatch):
    from positionbaseddynamics_tpu_torch import mpc
    orig = mpc.mppi_update

    def update(*a, **k):
        new, costs = orig(*a, **k)
        return new + 0.05, costs

    monkeypatch.setattr(mpc, "mppi_update", update)


FAULTS = [(c, f) for c in tiny.CELLS for f in (_unchanged, _altered)
          if c.endswith("sim-1")]
FAULTS += [(c, f) for c in tiny.CELLS
           for f in (_unchanged, _half_batch, _command_altered,
                     _first_rollout_handle, _last_rollout_altered)
           if c.endswith("mpc-k256")]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    r = _run(monkeypatch, cell)
    assert not r["correct"]
    assert r["failed"] >= 1


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_control_in_bfloat16_is_not_correct(monkeypatch, cell):
    from benchmark import calibrate, loops

    tiny.patch(monkeypatch)
    bench = spec.load()
    c = spec.cell(bench, cell)
    config, mix = spec.config_and_mix(bench, c)
    kind = spec.kind_module("reference", config["kind"])
    state, cset = spec.kind_module("scenes", config["kind"]).build(config,
                                                                   CPU)
    loop = loops.LOOPS[mix["loop"]](config, mix, state, cset, SEED, CPU,
                                    kind)
    win = loop.run(count=4, check={0, 1, 3})
    ref = harness.reference_for(config, mix, CPU, torch.float32, kind)
    ctl = harness.reference_for(config, mix, CPU, torch.bfloat16, kind)
    samples = calibrate.stand_in(config, mix, win.samples, ctl)
    with torch.no_grad():
        per = harness.numbers(config, mix, samples, ref)
        sound = harness.numbers(config, mix, win.samples, ref)
    limits = config["limits"][mix["loop"]]
    assert not harness.judge.verdict(per, limits)[0]
    assert harness.judge.verdict(sound, limits)[0]


def test_a_new_cell_of_existing_files_runs_without_an_edit(monkeypatch):
    bench = spec.load()
    bench["workloads"].append({"name": "bar-80x36x36.mpc-k256.again",
                               "config": "bar-80x36x36",
                               "traffic": "mpc-k256", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "bar-80x36x36.mpc-k256" in m.get("workloads", []):
            m["workloads"].append("bar-80x36x36.mpc-k256.again")
    r = _run(monkeypatch, "bar-80x36x36.mpc-k256.again", bench=bench)
    assert r["correct"]
    assert set(r["metrics"]) == {"setup_s", "plan_updates_per_s",
                                 "plan_update_p95_ms"}


def test_a_mix_of_rollouts_and_iterations_needs_only_data(monkeypatch):
    """A sim mix of 2 rollouts stepped together at 2 iterations, as the
    mix file's ``rollouts`` and ``step`` keys give it."""
    tiny.patch(monkeypatch)
    base = tiny.mix

    def mix(name):
        m = base(name)
        if m["loop"] == "sim":
            m.update(rollouts=2, step={"max_iterations": 2})
        return m

    monkeypatch.setattr(spec, "mix", mix)
    r = harness.run_cell(spec.load(), "cloth-320.sim-1", SEED, 0.4, False,
                         CPU, time.perf_counter())
    assert r["correct"], r["checks"]
