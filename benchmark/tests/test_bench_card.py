"""The cells at tiny sizes on the card, through the program's kernel
route: every run correct, the traced run reads the card (python -m
pytest benchmark/tests on the machine with the card; skipped without
one)."""
import time

import pytest

from benchmark import harness, spec
from benchmark.tests import tiny


@pytest.mark.card
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", tiny.CELLS)
def test_cells_are_correct_on_the_kernel_route(monkeypatch, capsys, card,
                                               cell, trace):
    tiny.patch(monkeypatch)
    r = harness.run_cell(spec.load(), cell, 2**31 + 99, 0.5, trace, card,
                         time.perf_counter())
    assert "path 'cuda_kernel'" in capsys.readouterr().err
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert r["breakdown"]["device_ops"]


@pytest.mark.card
def test_dam_reference_follows_the_kernels_at_12k(card):
    """The 12k dam (21×28×21 in a box of 5(21+1)×4·28×(21+1) spacings,
    the configuration's ratios) through ``make_fluid_step_fn`` on the card,
    three frames of the sim mix and the last judged against the reference
    under the configuration's own limits."""
    import json

    from benchmark import judge

    cfg = json.loads(
        (spec.ROOT / "benchmark/configs/dam-100k.json").read_text())
    cfg.update(block=[21, 28, 21], box_spacings=[110, 112, 22])
    mix = spec.mix("sim-1")
    state, scene = spec.kind_module("scenes", "pbf_dam").build(cfg, card)
    ref_kind = spec.kind_module("reference", "pbf_dam")
    loop = harness.make_loop(cfg, mix, state, scene, 2**31 + 5, card,
                             ref_kind)
    assert loop.route == "cuda_kernel"
    win = loop.run(count=40, check={0, 1, 20})
    ref = ref_kind.scene(cfg, card)
    per = judge.sim_numbers(ref, win.samples, int(mix["steps_per_frame"]))
    ok, failed, checks = judge.verdict(per, cfg["limits"]["sim"])
    assert ok, checks
    assert [s["index"] for s in win.samples] == [0, 1, 20, 39]
