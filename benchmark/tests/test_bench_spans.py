"""The benchmark's trace and readers on a trace that holds the program's
``pbd.*`` spans, which read the same as without them, and the reader of
the program's kernel-library counter."""
import sys

from benchmark import spec, trace
from benchmark.tests import test_bench_trace as base


def _ev(name, cat, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


UA, RT = "user_annotation", "cuda_runtime"


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


def test_the_trace_and_its_readers_are_unchanged_by_spans():
    a, b = trace.read(base.EVENTS), trace.read(WITH_SPANS)
    assert (a.window_s, a.busy_s, a.ops, a.gaps) == \
        (b.window_s, b.busy_s, b.ops, b.gaps)
    assert a.breakdown() == b.breakdown()
    for loop, periods in (("sim", 1), ("mpc", 2)):
        ra = base._Rec(loop, "grid_cloth", a, [(1, 10, 1)], periods, 2)
        rb = base._Rec(loop, "grid_cloth", b, [(1, 10, 1)], periods, 2)
        for name in ("device_idle_share.sim", "device_ops_per_step.sim",
                     "step_host_ms.sim", "scene_build_s",
                     "device_idle_share.frame", "device_ops_per_step.frame",
                     "step_host_ms.frame", "step_rate.frame",
                     "device_idle_share.plan", "planner_aux_ms.plan",
                     "cloth_kernel_roofline.plan",
                     "tet_kernel_roofline.plan"):
            r = spec.reader(name)
            assert r.read(ra) == r.read(rb), name
