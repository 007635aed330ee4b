"""The benchmark's trace and readers on a trace that holds the program's
``pbd.*`` spans: the readers that were there before read the same as
without them, the trace keeps the spans, every idle interval and the span
each device operation was launched in, and the span readers read them;
and the reader of the program's kernel-library counter."""
import gzip
import hashlib
import json
import sys

import pytest

from benchmark import spec, trace
from benchmark.tests import test_bench_trace as base


def _ev(name, cat, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


UA, RT, DRV = "user_annotation", "cuda_runtime", "cuda_driver"
# the readers the benchmark had before its trace kept the program's spans:
# each must read the same with the spans in the trace as without. Named
# here once, so that a reader added later, of spans or not, changes
# nothing in this file.
BEFORE_SPANS = (
    "cloth_kernel_roofline.plan", "device_idle_share.frame",
    "device_idle_share.plan", "device_idle_share.sim",
    "device_ops_per_step.frame", "device_ops_per_step.sim",
    "fluid_tables_ms.sim", "kernel_load_s", "pbf_kernel_roofline.sim",
    "planner_aux_ms.plan", "scene_build_s", "step_host_ms.frame",
    "step_host_ms.sim", "step_rate.frame", "tet_kernel_roofline.plan")


def test_kernel_load_reads_the_programs_counter(monkeypatch, capsys):
    from positionbaseddynamics_tpu_torch.utils import telemetry

    rec = base._Rec("sim", "grid_cloth", trace.read(base.EVENTS),
                    [(1, 10, 1)], 1, 2)
    reader = spec.reader("kernel_load_s")
    monkeypatch.setattr(telemetry, "counters", lambda: {
        "kernels.load_s": 0.25, "kernels.nvcc_builds": 3,
        "kernels.libraries_loaded": 3})
    assert reader.read(rec) == 0.25
    assert "3 nvcc builds" in capsys.readouterr().err
    monkeypatch.setattr(telemetry, "counters", lambda: {})
    assert reader.read(rec) is None
    # a program without the counters' module, as the parent
    monkeypatch.setitem(sys.modules,
                        "positionbaseddynamics_tpu_torch.utils.telemetry",
                        None)
    assert reader.read(rec) is None


# ``test_bench_trace.EVENTS`` with launches and the program's spans added
# where no gap's midpoint falls inside one shorter than its host operator
WITH_SPANS = base.EVENTS + [
    _ev("pbd.step", UA, 107.0, 33.0, tid=None),
    _ev("cudaLaunchKernel", RT, 108.0, 1.0, corr=1, tid=None),
    _ev("cudaLaunchKernel", RT, 112.0, 1.0, corr=2, tid=None),
    _ev("pbd.kernel.cloth", "gpu_user_annotation", 110.0, 30.0),
    _ev("pbd.step.planes", UA, 150.0, 40.0, tid=None),
]


# ``test_bench_trace.DAM_EVENTS`` with a fluid kernel wrapper's span, its
# launch and the span's device twin added
DAM_WITH_SPANS = base.DAM_EVENTS + [
    _ev("pbd.kernel.pbf_density_lambda", UA, 90.0, 20.0),
    _ev("cudaLaunchKernel", RT, 95.0, 2.0),
    _ev("pbd.kernel.pbf_density_lambda", "gpu_user_annotation", 100.0,
        108.0),
]


def test_the_trace_and_its_readers_are_unchanged_by_spans():
    for plain, spans, recs in (
            (base.EVENTS, WITH_SPANS,
             [lambda t, loop=loop, n=n: base._Rec(loop, "grid_cloth", t,
                                                  [(1, 10, 1)], n, 2)
              for loop, n in (("sim", 1), ("mpc", 2))]),
            (base.DAM_EVENTS, DAM_WITH_SPANS,
             [lambda t: base._DamRec(t, 8)])):
        a, b = trace.read(plain), trace.read(spans)
        assert (a.window_s, a.busy_s, a.ops, a.gaps) == \
            (b.window_s, b.busy_s, b.ops, b.gaps)
        assert a.idle == b.idle
        assert a.breakdown() == b.breakdown()
        assert a.spans == [] and b.spans
        for rec in recs:
            ra, rb = rec(a), rec(b)
            for name in BEFORE_SPANS:
                r = spec.reader(name)
                assert r.read(ra) == r.read(rb), name


def _launch(ts, corr, tid=1, cat=RT):
    return _ev("cudaLaunchKernel", cat, ts, 2.0, corr=corr, tid=tid)


# An MPPI update's slice: the expansion's copy and the control's kernels
# launched in their spans, the step kernel in its wrapper's span nested in
# ``pbd.step``, a launch on a thread with no span, a kernel whose launch
# call is missing, one with no correlation, one launched by the driver, and
# one launched in a span that ended before the window opened.
PLAN = [
    _ev("bench.window", UA, 0.0, 1000.0),
    _ev("pbd.scene.build", UA, -500.0, 100.0),
    _launch(-450.0, 8),
    _ev("elementwise_kernel", "kernel", 5.0, 3.0, corr=8),
    _ev("pbd.plan.rollouts", UA, 10.0, 700.0),
    _ev("pbd.plan.expand", UA, 20.0, 30.0),
    _ev("cudaMemcpyAsync", RT, 30.0, 2.0, corr=1, tid=1),
    _ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 60.0, 40.0, corr=1),
    _ev("pbd.plan.control", UA, 100.0, 50.0),
    _launch(110.0, 2),
    _ev("index_add_kernel", "kernel", 150.0, 30.0, corr=2),
    _launch(120.0, 3),
    _ev("elementwise_kernel", "kernel", 180.0, 20.0, corr=3),
    _launch(130.0, 7, cat=DRV),
    _ev("driver_launched_kernel", "kernel", 610.0, 10.0, corr=7),
    _ev("pbd.step", UA, 200.0, 300.0),
    _ev("pbd.kernel.cloth", UA, 210.0, 100.0),
    _launch(250.0, 4),
    _ev("cloth_substep_kernel<1>", "kernel", 260.0, 200.0, corr=4),
    _ev("pbd.kernel.cloth", "gpu_user_annotation", 260.0, 200.0),
    _launch(120.0, 5, tid=2),
    _ev("other_thread_kernel", "kernel", 470.0, 10.0, corr=5),
    _ev("orphan_kernel", "kernel", 500.0, 50.0, corr=6),
    _ev("bare_kernel", "kernel", 560.0, 40.0),
]


def test_the_trace_keeps_spans_launch_spans_and_every_idle_interval():
    t = trace.read(PLAN)
    assert [s[0] for s in t.spans] == [
        "pbd.plan.rollouts", "pbd.plan.expand", "pbd.plan.control",
        "pbd.step", "pbd.kernel.cloth"]
    assert t.spans[1] == ("pbd.plan.expand", 20.0, 30.0)
    assert [(o[0], s) for o, s in zip(t.ops, t.op_spans)] == [
        ("elementwise_kernel", "pbd.scene.build"),
        ("Memcpy DtoD (Device -> Device)", "pbd.plan.expand"),
        ("index_add_kernel", "pbd.plan.control"),
        ("elementwise_kernel", "pbd.plan.control"),
        ("cloth_substep_kernel<1>", "pbd.kernel.cloth"),
        ("other_thread_kernel", ""),
        ("orphan_kernel", ""),
        ("bare_kernel", ""),
        ("driver_launched_kernel", "pbd.plan.control")]
    assert t.idle == [(0.0, 5.0), (8.0, 52.0), (100.0, 50.0), (200.0, 60.0),
                      (460.0, 10.0), (480.0, 20.0), (550.0, 10.0),
                      (600.0, 10.0), (620.0, 380.0)]
    assert sorted((g[0], g[1]) for g in t.gaps) == t.idle
    assert sum(d for _a, d in t.idle) * 1e-6 == \
        pytest.approx(t.window_s - t.busy_s)
    assert t.span_intervals("pbd.step") == [(200.0, 500.0)]
    assert t.span_intervals("pbd.plan") == [(10.0, 710.0)]
    assert t.span_intervals("pbd.kernel") == [(210.0, 310.0)]
    assert t.span_intervals("pbd.ste") == []
    # only the 40 longest gaps are labelled; ``idle`` keeps every one
    many = [_ev("bench.window", UA, 0.0, 1000.0)] + [
        _ev("k", "kernel", 10.0 * i + 5.0, 5.0) for i in range(60)]
    t = trace.read(many)
    assert len(t.idle) == 61 and len(t.gaps) == 40
    assert t.op_spans == [""] * 60 and t.spans == []


def test_intervals_merge_and_overlap():
    assert trace.merged([(5, 7), (0, 2), (1, 3), (7, 9)]) == \
        [(0, 3), (5, 9)]
    assert trace.merged([]) == []
    a, b = [(0, 3), (5, 9)], [(2, 6), (8, 20)]
    assert trace.overlap(a, b) == 1 + 1 + 1
    assert trace.overlap(a, []) == 0


def test_planner_span_readers_read_their_spans_device_time():
    t = trace.read(PLAN)
    plan = base._Rec("mpc", "grid_cloth", t, [(256, 50, 1)], 2, 20)
    control = spec.reader("plan_control_ms.plan").read(plan)
    assert control == pytest.approx((30 + 20 + 10) * 1e-3 / 2)
    assert spec.reader("plan_expand_ms.plan").read(plan) == \
        pytest.approx(40e-3 / 2)
    sim = base._Rec("sim", "grid_cloth", t, [(1, 10, 1)], 1, 2)
    bare = base._Rec("mpc", "grid_cloth", trace.read(base.EVENTS),
                     [(1, 10, 1)], 2, 2)
    no_expand = base._Rec("mpc", "grid_cloth", trace.read(
        [e for e in PLAN if e.get("args") != {"correlation": 1}]), [], 2,
        2)
    for name in ("plan_control_ms.plan", "plan_expand_ms.plan"):
        assert spec.reader(name).read(sim) is None
        assert spec.reader(name).read(bare) is None
    assert spec.reader("plan_expand_ms.plan").read(no_expand) is None
    assert spec.reader("plan_control_ms.plan").read(no_expand) == control


# Two sim steps of the tet kernel route: each ``pbd.step`` holds the
# conversion and the wrapper's span (nested in itself, as a wrapper that
# calls another), whose kernel runs after the step has returned; the
# device twin of a span is no host span.
SIM = [
    _ev("bench.window", UA, 0.0, 1000.0),
    _ev("pbd.step", UA, 100.0, 300.0),
    _ev("pbd.step.planes", UA, 110.0, 40.0),
    _ev("pbd.kernel.tet", UA, 150.0, 100.0),
    _ev("pbd.kernel.tet", UA, 160.0, 80.0),
    _launch(200.0, 1),
    _ev("tet_substep_kernel<0>", "kernel", 300.0, 50.0, corr=1),
    _ev("pbd.kernel.tet", "gpu_user_annotation", 300.0, 50.0),
    _ev("pbd.step", UA, 500.0, 300.0),
    _ev("pbd.kernel.tet", UA, 550.0, 100.0),
    _launch(600.0, 2),
    _ev("tet_substep_kernel<0>", "kernel", 700.0, 200.0, corr=2),
]


def test_step_span_readers_read_host_time_and_idle_under_the_step():
    t = trace.read(SIM)
    assert t.op_spans == ["pbd.kernel.tet", "pbd.kernel.tet"]
    sim = base._Rec("sim", "grid_tet", t, [(1, 10, 1)], 1, 2)
    # union of the wrapper spans, 150-250 and 550-650, over that of the
    # steps, 100-400 and 500-800
    assert spec.reader("step_wrapper_share.frame").read(sim) == \
        pytest.approx(100 * 200 / 600)
    # idle 0-300, 350-700, 900-1000 (750 µs); under a step 100-300,
    # 350-400, 500-700 (450 µs)
    assert spec.reader("idle_in_step_share.frame").read(sim) == \
        pytest.approx(60.0)
    plan = base._Rec("mpc", "grid_tet", t, [(1, 10, 1)], 2, 2)
    plain = base._Rec("sim", "grid_cloth", trace.read(base.EVENTS),
                      [(1, 10, 1)], 1, 2)
    no_ops = base._Rec("sim", "grid_tet", trace.read(
        [e for e in SIM if e["cat"] != "kernel"]), [(1, 10, 1)], 1, 2)
    for name in ("step_wrapper_share.frame", "idle_in_step_share.frame"):
        assert spec.reader(name).read(plan) is None
        assert spec.reader(name).read(plain) is None
    assert spec.reader("idle_in_step_share.frame").read(no_ops) is None
    assert spec.reader("step_wrapper_share.frame").read(no_ops) == \
        pytest.approx(100 * 200 / 600)
    # a wrapper span outside every step counts for nothing
    outside = base._Rec("sim", "grid_tet", trace.read(
        [e for e in SIM if not e["name"].startswith("pbd.step")]
        + [_ev("pbd.step", UA, 900.0, 50.0)]), [(1, 10, 1)], 1, 2)
    assert spec.reader("step_wrapper_share.frame").read(outside) is None


TRACES = spec.HERE / "tests" / "traces"
# the traced slice of each recorded run: loop, kind, periods, steps
SLICES = {"cloth-320.mpc-k256": ("mpc", "grid_cloth", 3, 0),
          "bar-80x36x36.sim-1": ("sim", "grid_tet", 25, 200)}


@pytest.mark.parametrize("cell", sorted(SLICES))
def test_recorded_traces_read_as_the_parent_and_the_card_read_them(cell):
    """The events of a traced run of ``cell`` on an H100 80GB HBM3 (the
    profiler's Chrome trace, ``pbd.*`` spans in; kept are the complete
    events of the categories the trace reads): the fields the trace had
    before it kept spans read as the earlier ``trace.py`` read them
    (``recorded.json``: their digest and breakdown from it), and the
    readers read what the harness read on the card."""
    with gzip.open(TRACES / f"{cell}.json.gz", "rt") as f:
        events = json.load(f)
    want = json.loads((TRACES / "recorded.json").read_text())[cell]
    t = trace.read(events)
    assert (t.window_s, t.busy_s, len(t.ops)) == \
        (want["window_s"], want["busy_s"], want["ops"])
    digest = hashlib.sha256(json.dumps([t.ops, t.gaps]).encode())
    assert digest.hexdigest() == want["ops_and_gaps_sha256"]
    assert json.loads(json.dumps(t.breakdown())) == want["breakdown"]
    loop, kind, periods, steps = SLICES[cell]
    rec = base._Rec(loop, kind, t, [], periods, steps)
    for name, value in want["read_on_the_card"].items():
        assert spec.reader(name).read(rec) == value, name
    assert len(t.op_spans) == len(t.ops) and t.spans and t.idle
