"""Whole runs of each cell on the CPU at tiny sizes, through the
harness's own path with the look for a card skipped: sound runs come
out correct, and runs with the timed path broken underneath, or with the
reference in bfloat16 in the program's place (the control), come out
not correct at the configurations' own limits."""
import importlib
import time

import pytest
import torch

from benchmark import harness, judge, loops, spec
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
        host = {"step_host_ms.sim", "step_host_ms.frame", "step_rate.frame"}
        assert host & {m["name"] for m in want} <= set(r["metrics"])
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


def _fluid_model():
    return importlib.import_module(
        "positionbaseddynamics_tpu_torch.fluids.model")


def _fluid_unchanged(monkeypatch):
    monkeypatch.setattr(_fluid_model(), "fluid_step",
                        lambda state, scene: state)


def _fluid_altered(monkeypatch):
    import dataclasses
    fm = _fluid_model()
    orig = fm.fluid_step

    def step(state, scene):
        s = orig(state, scene)
        x = s.x.clone()
        x[7, 1] += 0.1
        return dataclasses.replace(s, x=x)

    monkeypatch.setattr(fm, "fluid_step", step)


def _density_iteration_left_out(monkeypatch):
    fm = _fluid_model()
    orig = fm.pbf_iterations

    def iterations(spec, xt, mt, active, nbr, nbr_ok, n_iter, *a, **k):
        return orig(spec, xt, mt, active, nbr, nbr_ok, n_iter - 1, *a, **k)

    monkeypatch.setattr(fm, "pbf_iterations", iterations)


def _cell_cap_too_small(monkeypatch):
    import dataclasses
    from benchmark.scenes import pbf_dam
    orig = pbf_dam.build

    def build(config, device):
        state, scene = orig(config, device)
        grid = dataclasses.replace(scene.cellgrid, cap=4)
        return state, dataclasses.replace(scene, cellgrid=grid)

    monkeypatch.setattr(pbf_dam, "build", build)


FLUID_FAULTS = (_fluid_unchanged, _fluid_altered, _density_iteration_left_out,
                _cell_cap_too_small)
FAULTS = [(c, f) for c in tiny.CELLS for f in (_unchanged, _altered)
          if c.endswith("sim-1") and not c.startswith("dam-")]
FAULTS += [(c, f) for c in tiny.CELLS
           for f in (_unchanged, _half_batch, _command_altered,
                     _first_rollout_handle, _last_rollout_altered)
           if c.endswith("mpc-k256")]
FAULTS += [("dam-100k.sim-1", f) for f in FLUID_FAULTS]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    r = _run(monkeypatch, cell)
    assert not r["correct"]
    assert r["failed"] >= 1
    if fault is _cell_cap_too_small:
        assert r["checks"]["overflow"]["value"] > 0


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_control_in_bfloat16_is_not_correct(monkeypatch, cell):
    from benchmark import calibrate

    tiny.patch(monkeypatch)
    bench = spec.load()
    c = spec.cell(bench, cell)
    config, mix = spec.config_and_mix(bench, c)
    kind = spec.kind_module("reference", config["kind"])
    state, cset = spec.kind_module("scenes", config["kind"]).build(config,
                                                                   CPU)
    loop = harness.make_loop(config, mix, state, cset, SEED, CPU, kind)
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


def _stub_kind(monkeypatch):
    """A kind made of new modules alone, as a later PR would add them as
    files: ballistic particles stepped by a stepper of their own that
    carries ``dt`` (halved each step), its reference and its work."""
    import dataclasses
    import sys
    import types

    @dataclasses.dataclass(frozen=True)
    class State:
        x: torch.Tensor
        v: torch.Tensor
        dt: torch.Tensor

    def step(s):
        v = s.v + s.dt * torch.tensor([0.0, -9.81, 0.0])
        return State(x=s.x + s.dt * v, v=v, dt=s.dt * 0.5)

    step.path = "stub_path"

    class Drive:
        entry = "stub_entry"
        substeps, iterations, judges_last = 1, 1, True

        def __init__(self, config, mix, state, scene, device):
            self.fn = step

        positions = staticmethod(lambda s: s.x)
        free = staticmethod(lambda s: torch.ones(len(s.x), dtype=torch.bool))
        start = staticmethod(lambda s, v: dataclasses.replace(s, v=v))
        save_in = staticmethod(lambda s: {"x": s.x.clone(), "v": s.v.clone(),
                                          "dt": s.dt.clone()})
        save_out = staticmethod(lambda s: {"v": s.v.clone(),
                                           "old_x": s.x.clone(),
                                           "last_x": s.x.clone(),
                                           "dt": s.dt.clone()})

    x0 = torch.arange(12.0).reshape(4, 3)

    class Ref:
        dtype = torch.float32

        def __init__(self):
            self.x0 = x0

        def frame(self, inputs, start, steps):
            x = self.x0 if start else inputs["x"]
            v, dt = inputs["v"], (torch.tensor(0.01) if start
                                  else inputs["dt"])
            for _ in range(steps):
                v = v + dt * torch.tensor([0.0, -9.81, 0.0])
                x, dt = x + dt * v, dt * 0.5
            return {"x": x, "v": v, "old_x": x, "last_x": x, "dt": dt}

        @staticmethod
        def numbers(out, ref):
            return {"dt_gap_s": abs(float(out["dt"]) - float(ref["dt"]))}

    mods = {
        "scenes": dict(build=lambda config, device: (
            State(x=x0.clone(), v=torch.zeros(4, 3), dt=torch.tensor(0.01)),
            None), Drive=Drive),
        "reference": dict(scene=lambda config, device="cpu",
                          dtype=torch.float32: Ref()),
        "work": dict(substep=lambda config, n_batch, iterations: (1e3, 1e3)),
    }
    for part, attrs in mods.items():
        m = types.ModuleType(f"benchmark.{part}.stub_fall")
        m.__dict__.update(attrs)
        monkeypatch.setitem(sys.modules, m.__name__, m)
    config = {"name": "stub-4", "kind": "stub_fall", "step": {},
              "limits": {"sim": {"x_gap_m": 1e-5, "v_gap_mps": 1e-5,
                                 "mean_gap_m": 1e-5, "dt_gap_s": 0.0}}}
    base = spec.config
    monkeypatch.setattr(spec, "config", lambda bench, name, root=None:
                        dict(config) if name == "stub-4"
                        else base(bench, name))
    monkeypatch.setattr(spec, "mix", tiny.mix)
    bench = spec.load()
    bench["configs"].append({"name": "stub-4", "source": "test",
                             "file": "none", "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "stub-4.sim-1", "config": "stub-4",
                               "traffic": "sim-1", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "bar-80x36x36.sim-1" in m.get("workloads", []):
            m["workloads"].append("stub-4.sim-1")
    return bench


@pytest.mark.parametrize("trace", [False, True])
def test_a_kind_with_its_own_stepper_needs_only_new_files(monkeypatch, capsys,
                                                          trace):
    bench = _stub_kind(monkeypatch)
    r = harness.run_cell(bench, "stub-4.sim-1", SEED, 0.2, trace, CPU,
                         time.perf_counter())
    assert "steps through stub_entry, path 'stub_path'" in \
        capsys.readouterr().err
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"x_gap_m", "v_gap_mps", "mean_gap_m",
                                "dt_gap_s"}
    if not trace:
        assert set(r["metrics"]) == {"setup_s", "sim_frame_p95_ms"}
    # the last frame is judged too, for a drive that asks for it
    assert r["attempted"] >= 1


def _parent_frames(state, fn, mix, frames, check):
    """The frames of ``make_step_fn``'s scenes as the sim loop saved them
    before kinds could bring their own drives, restated."""
    import dataclasses

    p = state.particles
    gen = torch.Generator(device=CPU)
    gen.manual_seed(loops.seed64(SEED, 1))
    v = torch.rand(p.x.shape, generator=gen, device=CPU) * 2.0 - 1.0
    v = v * (float(mix["initial_speed"]) / 3.0 ** 0.5)
    v = torch.where((p.inv_mass > 0)[:, None], v, torch.zeros_like(v))
    s = dataclasses.replace(state, particles=dataclasses.replace(p, v=v))
    out = []
    for i in range(frames):
        before = {"x": s.particles.x.clone(), "v": s.particles.v.clone()}
        for _ in range(int(mix["steps_per_frame"])):
            s = fn(s)
        if i in check:
            q = s.particles
            out.append({"index": i, "start": i == 0, "in": before,
                        "out": {k: getattr(q, k).clone()
                                for k in ("x", "v", "old_x", "last_x")}})
    return out


def _parent_numbers(ref, samples, spf):
    """``judge.sim_numbers`` before kinds could run their own frames,
    restated."""
    out = []
    for s in samples:
        x = ref.x0 if s["start"] else s["in"]["x"]
        v = s["in"]["v"]
        for _ in range(spf):
            x, v, old, last = ref.step(x, v)
        o = s["out"]
        out.append({
            "x_gap_m": max(judge._gap(o["x"], x), judge._gap(o["old_x"], old),
                           judge._gap(o["last_x"], last)),
            "v_gap_mps": judge._gap(o["v"], v),
            "mean_gap_m": torch.linalg.vector_norm(
                o["x"].double().mean(-2) - x.double().mean(-2)).item()})
    return out


@pytest.mark.parametrize("name", ["cloth-320", "bar-80x36x36"])
def test_kinds_without_a_drive_step_as_before(monkeypatch, name):
    from positionbaseddynamics_tpu_torch import solver

    built = []
    make = solver.make_step_fn

    def spy(*a, **k):
        built.append(make(*a, **k))
        return built[-1]

    monkeypatch.setattr(solver, "make_step_fn", spy)
    cfg, mix = tiny.config(name), tiny.mix("sim-1")
    ref_kind = spec.kind_module("reference", cfg["kind"])
    state, cset = spec.kind_module("scenes", cfg["kind"]).build(cfg, CPU)
    loop = harness.make_loop(cfg, mix, state, cset, SEED, CPU, ref_kind)
    assert len(built) == 1 and loop.fn is built[0]
    assert isinstance(loop.drive, loops.ParticleDrive)
    assert loop.entry == "make_step_fn" and loop.route == built[0].path
    check = {0, 2}
    win = loop.run(count=3, check=check)
    spf = int(mix["steps_per_frame"])
    assert win.work == [(1, cfg["step"]["substeps"] * spf * 3,
                         cfg["step"]["max_iterations"])]
    want = _parent_frames(state, make(cset, loops._step_config(cfg), CPU),
                          mix, 3, check)
    assert [(s["index"], s["start"]) for s in win.samples] == \
        [(s["index"], s["start"]) for s in want]
    for a, b in zip(win.samples, want):
        for side in ("in", "out"):
            assert set(a[side]) == set(b[side])
            for k in a[side]:
                assert torch.equal(a[side][k], b[side][k]), (side, k)
    ref = harness.reference_for(cfg, mix, CPU, torch.float32, ref_kind)
    with torch.no_grad():
        assert judge.sim_numbers(ref, win.samples, spf) == \
            _parent_numbers(ref, want, spf)
