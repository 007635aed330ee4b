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
