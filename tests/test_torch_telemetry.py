"""The port's spans and counters (``utils/telemetry.py``): spans only while
a torch profiler records, nested as the layers call each other, and
counters that count. CPU tests, no JAX; the last test needs the card
(``python -m pytest tests/test_torch_telemetry.py`` there) and skips
without it."""
import contextlib
import importlib
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_collision_scenes as scenes
from positionbaseddynamics_tpu_torch import mpc
from positionbaseddynamics_tpu_torch.models import SceneBuilder
from positionbaseddynamics_tpu_torch.solver import StepConfig, make_step_fn
from positionbaseddynamics_tpu_torch.solver import grid_cloth_cuda as gcc
from positionbaseddynamics_tpu_torch.utils import PhaseTimers, telemetry

step_mod = importlib.import_module(
    "positionbaseddynamics_tpu_torch.solver.step")


def _cloth(n, m, device="cpu"):
    b = SceneBuilder()
    tm = b.add_regular_triangle_model(n, m, scale=(2.0, 2.0))
    b.set_mass(tm.offset, 0.0)
    b.set_mass(tm.offset + n - 1, 0.0)
    b.add_cloth_constraints(tm, method=4, distance_stiffness=1e5)
    b.add_bending_constraints(tm, method=3, stiffness=0.05)
    return b.build(device=device)


def _trace(prof, tmp_path):
    """The program's spans of a finished profile, each as ``(name, start
    µs, µs, parent name)``, the parent the innermost enclosing span of the
    same thread, None at the top."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted(((e["name"], float(e["ts"]), float(e["dur"]),
                     e.get("tid")) for e in events
                    if e.get("ph") == "X"
                    and e.get("cat") == "user_annotation"
                    and e["name"].startswith("pbd.")),
                   key=lambda s: (s[1], -s[2]))
    out = []
    for name, t, d, tid in spans:
        outer = [s for s in spans if s[3] == tid and s[1] <= t
                 and t + d <= s[1] + s[2] and s[:3] != (name, t, d)]
        parent = min(outer, key=lambda s: s[2])[0] if outer else None
        out.append((name, t, d, parent))
    return out


def _parents(spans, name):
    return {p for n, _t, _d, p in spans if n == name}


def test_span_without_a_profiler_is_the_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    a, b = telemetry.span("pbd.a"), telemetry.span("pbd.b")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        inside = telemetry.span("pbd.c")
        with inside:
            torch.ones(2).sum()
    assert isinstance(inside, torch.profiler.record_function)
    names = [e.name for e in prof.events()]
    assert "pbd.c" in names and "pbd.a" not in names


def test_traced_keeps_the_function_and_its_name():
    @telemetry.traced("pbd.test")
    def f(x, k=1):
        """Doc."""
        return x + k

    assert f(1, k=2) == 3 and f.__name__ == "f" and f.__doc__ == "Doc."


def test_counters_count_and_reset():
    before = telemetry.counters()
    telemetry.count("test.events")
    telemetry.count("test.events", 2)
    telemetry.count("test.seconds", 0.5)
    c = telemetry.counters()
    assert c["test.events"] == before.get("test.events", 0) + 3
    assert c["test.seconds"] == before.get("test.seconds", 0) + 0.5
    c["test.events"] = -1                       # a copy
    assert telemetry.counters()["test.events"] != -1
    kept = {n: v for n, v in telemetry.counters().items()
            if n.startswith("kernels.")}
    telemetry.reset()
    assert telemetry.counters() == kept


def test_reset_keeps_the_kernel_librarys_counters(monkeypatch):
    """The libraries load once a process, so ``reset`` keeps ``kernels.*``
    and clears the launches; ``launches`` reads a launch counter."""
    monkeypatch.setattr(telemetry, "_counts", {})
    telemetry.count("kernels.load_s", 0.25)
    telemetry.count("kernels.libraries_loaded", 3)
    telemetry.count("kernel.cloth_substep.launches", 5)
    assert telemetry.launches("cloth_substep") == 5
    assert telemetry.launches("tet_fused") == 0
    telemetry.reset()
    assert telemetry.counters() == {"kernels.load_s": 0.25,
                                    "kernels.libraries_loaded": 3}
    assert telemetry.launches("cloth_substep") == 0


def test_pytorch_route_step_spans_nest(tmp_path):
    """A CPU step of a small grid cloth over a sphere: the scene build,
    the route's choice and the step with its substeps, velocity pass and
    collision detection."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, cset, pipe = scenes.cloth_on_sphere("torch", n=6)
        fn = make_step_fn(cset, StepConfig(), device="cpu", pipeline=pipe)
        fn(fn(state))
    spans = _trace(prof, tmp_path)
    names = [n for n, *_ in spans]
    assert names.count("pbd.step") == 2
    assert _parents(spans, "pbd.scene.build") == {None}
    assert _parents(spans, "pbd.route.plan") == {None}
    assert _parents(spans, "pbd.step") == {None}
    assert _parents(spans, "pbd.step.substeps") == {"pbd.step"}
    assert _parents(spans, "pbd.step.velocity") == {"pbd.step"}
    assert _parents(spans, "pbd.step.collision") <= {"pbd.step",
                                                     "pbd.step.velocity"}
    assert names.count("pbd.step.collision") >= 2
    assert not any(n.startswith("pbd.kernel.") for n in names)


def test_kernel_route_step_spans_nest(monkeypatch, tmp_path):
    """The kernel route's step with the launch stood in by the kernel's
    plain version (the kernel has no CPU mode): the conversions into and
    out of planes, and the wrapper's span between them, inside the
    step."""
    state, cset = _cloth(6, 5)
    g = cset.grid_cloths[0]
    cfg = StepConfig()
    plan = step_mod._cloth_plan(g, cfg)
    w = state.particles.inv_mass

    def stand_in(xp, vp, *a, **k):
        x, v = gcc.cloth_substep_reference(
            g, gcc.from_planes(xp, ()), gcc.from_planes(vp, ()), w,
            h=cfg.dt / cfg.substeps)
        return gcc.to_planes(x, g.height, g.width), \
            gcc.to_planes(v, g.height, g.width)

    monkeypatch.setattr(gcc, "cloth_substep_cuda", stand_in)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = step_mod.step(state, cset, cfg, plan)
    ref = step_mod.step(state, cset, cfg)
    assert torch.allclose(out.particles.x, ref.particles.x, atol=1e-5)
    spans = _trace(prof, tmp_path)
    assert [n for n, *_ in spans] == ["pbd.step", "pbd.step.planes",
                                      "pbd.kernel.cloth", "pbd.step.planes"]
    assert [p for *_, p in spans] == [None] + ["pbd.step"] * 3


@pytest.mark.parametrize("planner", ["mppi", "cem"])
def test_planner_update_spans_nest(tmp_path, planner):
    """A tiny update: the update, the rollouts of the sequence cost with
    the expansion, a control, a step and a running cost each horizon
    step and the terminal cost, then the weights or the refit."""
    state, cset = _cloth(5, 4)
    cfg = StepConfig()
    control = mpc.PinVelocityControl((0,))
    seq = mpc.make_sequence_cost(
        cset, cfg, control, running_cost=mpc.control_effort(1e-3),
        terminal_cost=mpc.particle_target([7], (0.0, 0.0, 0.0)),
        device="cpu")
    gen = torch.Generator().manual_seed(3)
    k, horizon = 4, 3
    nominal = torch.zeros(horizon, 3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if planner == "mppi":
            mpc.mppi_update(state, nominal, seq,
                            mpc.MPPIConfig(horizon=horizon, num_samples=k),
                            generator=gen)
        else:
            mpc.cem_update(state, nominal, torch.ones_like(nominal), seq,
                           mpc.CEMConfig(horizon=horizon, num_samples=k),
                           generator=gen)
    spans = _trace(prof, tmp_path)
    names = [n for n, *_ in spans]
    update = f"pbd.{planner}.update"
    inner = "pbd.mppi.weights" if planner == "mppi" else "pbd.cem.refit"
    assert _parents(spans, update) == {None}
    assert _parents(spans, "pbd.plan.rollouts") == {update}
    assert _parents(spans, inner) == {update}
    for child, n in (("pbd.plan.expand", 1), ("pbd.plan.control", horizon),
                     ("pbd.step", horizon), ("pbd.plan.cost", horizon + 1)):
        assert names.count(child) == n, child
        assert _parents(spans, child) == {"pbd.plan.rollouts"}, child


def test_phase_timers_read_the_steps_spans():
    """The timers' phases are the step's own spans: the projection is
    the substeps' span, inside the step's."""
    state, cset = _cloth(6, 5)
    timers = PhaseTimers(cset, StepConfig(), device="cpu")
    avg = timers.measure(state, repeats=2)
    assert list(avg) == ["simulation step",
                         "position constraints projection"]
    assert 0 < avg["position constraints projection"] < \
        avg["simulation step"]


def test_refused_launches_count_nothing():
    state, cset = _cloth(6, 5)
    g = cset.grid_cloths[0]
    xp = gcc.to_planes(state.particles.x, g.height, g.width)
    before = telemetry.counters()
    with pytest.raises(ValueError, match="CUDA"):
        gcc.cloth_substep_cuda(xp, xp.clone(), torch.ones(5, 6),
                               torch.ones(5, 6), torch.ones(5, 6),
                               gcc.kernel_params(g, h=1e-3))
    assert telemetry.counters() == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _launch_spans(events, match, window):
    """For each device kernel whose name holds ``match`` and whose launch
    (the runtime or driver event of the same correlation id) lies inside
    the host span ``window``: the innermost ``pbd.*`` span of the
    launching thread around the launch, None where there is none."""
    xs = [e for e in events if e.get("ph") == "X"]

    def corr(e):
        return (e.get("args") or {}).get("correlation")

    def inside(e, outer):
        return (outer.get("tid") == e.get("tid")
                and float(outer["ts"]) <= float(e["ts"])
                and float(e["ts"]) + float(e["dur"])
                <= float(outer["ts"]) + float(outer["dur"]))

    win = next(e for e in xs if e["name"] == window
               and e.get("cat") == "user_annotation")
    launch = {corr(e): e for e in xs
              if e.get("cat") in ("cuda_runtime", "cuda_driver")}
    spans = [e for e in xs if e.get("cat") == "user_annotation"
             and e["name"].startswith("pbd.")]
    out = []
    for k in xs:
        la = launch.get(corr(k))
        if (k.get("cat") != "kernel" or match not in k["name"]
                or la is None or not inside(la, win)):
            continue
        around = [sp for sp in spans if inside(la, sp)]
        out.append(min(around, key=lambda sp: float(sp["dur"]))["name"]
                   if around else None)
    return out


def test_kernel_route_on_card_is_attributed_and_counted(cuda, tmp_path):
    """On the card: the launch counter equals the cloth kernels the
    profiler saw, every one of them launched inside ``pbd.kernel.cloth``,
    and the timers' projection phase is the kernel wrapper's span."""
    state, cset = _cloth(40, 37, device=cuda)
    cfg = StepConfig()
    fn = make_step_fn(cset, cfg, cuda)
    assert fn.path == "cuda_kernel"
    s = fn(state)                                   # builds and loads
    torch.cuda.synchronize()
    assert telemetry.counters()["kernels.load_s"] > 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s = fn(s)                       # the profiler's first launches
        torch.cuda.synchronize()
        before = telemetry.launches("cloth_substep")
        with torch.profiler.record_function("test.window"):
            for _ in range(3):
                s = fn(s)
        torch.cuda.synchronize()
    launches = telemetry.launches("cloth_substep") - before
    assert launches == 3 * cfg.substeps
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    kernels = _launch_spans(json.loads(path.read_text())["traceEvents"],
                            "cloth_", "test.window")
    assert len(kernels) == launches
    assert set(kernels) == {"pbd.kernel.cloth"}
    phases = PhaseTimers(cset, cfg, device=cuda).measure(s, repeats=2)
    assert 0 < phases["position constraints projection"] < \
        phases["simulation step"]
