"""The trace reading and the per-layer readers on made-up timelines."""
import pytest

from benchmark import loops, spec, trace


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    _ev("bench.window", "user_annotation", 100.0, 100.0),
    _ev("bench.step", "user_annotation", 100.0, 40.0),
    _ev("aten::copy_", "cpu_op", 150.0, 30.0),
    _ev("cloth_substep_kernel<1>", "kernel", 110.0, 20.0),
    _ev("cloth_substep_kernel<1>", "kernel", 120.0, 20.0),   # overlaps
    _ev("Memcpy DtoH", "gpu_memcpy", 190.0, 30.0),          # past the end
    _ev("elementwise", "kernel", 50.0, 10.0),               # before it
]


def test_busy_is_the_union_inside_the_window():
    t = trace.read(EVENTS)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(40e-6)     # 110–140 and 190–200
    assert len(t.ops) == 3
    gaps = sorted((g[0], g[1]) for g in t.gaps)
    assert gaps == [(100.0, 10.0), (140.0, 50.0)]
    labels = dict(((g[0], g[2]) for g in t.gaps))
    assert labels[140.0] == "bench.window/aten::copy_"    # at 165 µs
    assert labels[100.0] == "bench.step"


def test_breakdown_sums_by_name_in_seconds():
    b = trace.read(EVENTS).breakdown()
    assert b["device_ops"][0] == ["cloth_substep_kernel<1>",
                                  pytest.approx(40e-6)]
    assert b["idle_gaps"][0][1] == pytest.approx(50e-6)


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(ValueError):
        trace.read(EVENTS[1:])


class _Rec:
    """A stand-in of ``harness.Record`` for the readers."""

    def __init__(self, loop, kind, tr, work, periods, steps):
        self.loop, self.kind, self.trace = loop, kind, tr
        w = loops.Window()
        w.work, w.periods, w.steps = work, [0.1] * periods, steps
        self.window = w
        self.scene_build_s = 1.5
        self.untraced = None
        if loop == "sim":
            u = loops.Window()
            u.periods, u.steps, u.seconds = [0.1] * 5, 40, 0.5
            u.step_host_s = [2e-4, 4e-4]
            self.untraced = u
        self.step_host_s = u.step_host_s if loop == "sim" else []
        self.config = {"width": 320, "height": 320}

    def least_seconds(self, kind):
        from benchmark.work import grid_cloth, peaks
        return sum(n * peaks.least_seconds(*grid_cloth.substep(
            self.config, b, it))[0] for b, n, it in self.window.work)


def test_readers_read_their_numbers():
    tr = trace.read(EVENTS)
    sim = _Rec("sim", "grid_cloth", tr, [(1, 10, 1)], 1, 2)
    assert spec.reader("device_idle_share.sim").read(sim) == \
        pytest.approx(60.0)
    assert spec.reader("device_ops_per_step.sim").read(sim) == 1.5
    assert spec.reader("step_host_ms.sim").read(sim) == pytest.approx(0.3)
    assert spec.reader("scene_build_s").read(sim) == 1.5
    assert spec.reader("device_idle_share.plan").read(sim) is None
    assert spec.reader("step_rate.frame").read(sim) == pytest.approx(80.0)
    plan = _Rec("mpc", "grid_cloth", tr, [(1, 10, 1)], 2, 2)
    assert spec.reader("step_rate.frame").read(plan) is None
    for name in ("step_host_ms", "device_ops_per_step", "device_idle_share"):
        for rec in (sim, plan):
            assert spec.reader(name + ".frame").read(rec) == \
                spec.reader(name + ".sim").read(rec), name
    aux = spec.reader("planner_aux_ms.plan").read(plan)
    assert aux == pytest.approx(30e-3 / 2)      # the copy, per update
    roof = spec.reader("cloth_kernel_roofline.plan").read(plan)
    assert roof == pytest.approx(100 * plan.least_seconds("grid_cloth")
                                 / 40e-6)
    assert spec.reader("tet_kernel_roofline.plan").read(plan) is None


def test_readers_read_nothing_without_device_operations():
    tr = trace.read(EVENTS[:3])
    rec = _Rec("mpc", "grid_cloth", tr, [(4, 10, 1)], 1, 1)
    for name in ("cloth_kernel_roofline.plan", "device_idle_share.plan",
                 "planner_aux_ms.plan"):
        assert spec.reader(name).read(rec) is None


class _DamRec(_Rec):
    """A traced dam run: B3–B5 beside the fluid tables' operations."""

    def __init__(self, tr, steps):
        super().__init__("sim", "pbf_dam", tr, [(1, steps, 5)], steps // 8,
                         steps)
        import json
        self.config = json.loads(
            (spec.ROOT / "benchmark/configs/dam-100k.json").read_text())

    def least_seconds(self, kind):
        from benchmark.work import pbf_dam, peaks
        return sum(n * peaks.least_seconds(*pbf_dam.substep(
            self.config, b, it))[0] for b, n, it in self.window.work)


DAM_EVENTS = [
    _ev("bench.window", "user_annotation", 0.0, 4000.0),
    _ev("pbf_density_lambda_kernel", "kernel", 100.0, 108.0),
    _ev("pbf_corrections_kernel", "kernel", 300.0, 105.0),
    _ev("pbf_xsph_kernel", "kernel", 500.0, 99.0),
    _ev("radixSortKernel", "kernel", 700.0, 40.0),
    _ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 800.0, 20.0),
    _ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 900.0, 60.0),
]


def test_dam_readers_read_the_kernels_and_the_tables():
    tr = trace.read(DAM_EVENTS)
    rec = _DamRec(tr, 8)
    roof = spec.reader("pbf_kernel_roofline.sim").read(rec)
    assert roof == pytest.approx(100 * rec.least_seconds("pbf_dam")
                                 / 312e-6)
    assert 0 < roof < 100
    # the sort and the copy a step, not the kernels nor the frame's copy
    # to the host
    assert spec.reader("fluid_tables_ms.sim").read(rec) == \
        pytest.approx(60e-3 / 8)
    cloth = _Rec("sim", "grid_cloth", trace.read(EVENTS), [(1, 10, 1)], 1, 2)
    assert spec.reader("pbf_kernel_roofline.sim").read(cloth) is None
    assert spec.reader("fluid_tables_ms.sim").read(cloth) is None
    no_pbf = trace.read([e for e in DAM_EVENTS if "pbf_" not in e["name"]])
    assert spec.reader("pbf_kernel_roofline.sim").read(
        _DamRec(no_pbf, 8)) is None
    assert spec.reader("fluid_tables_ms.sim").read(_DamRec(no_pbf, 8)) \
        is None
