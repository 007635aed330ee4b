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
        self.step_host_s = [2e-4, 4e-4]
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
    plan = _Rec("mpc", "grid_cloth", tr, [(1, 10, 1)], 2, 2)
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
