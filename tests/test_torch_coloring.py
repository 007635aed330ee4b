"""The port's greedy colouring (``solver/coloring.py``) against the JAX
package's: the colours and their count are equal exactly, and no two rows
of one colour share an item (a row may name an item twice)."""
import numpy as np
import pytest

from positionbaseddynamics_tpu.solver.coloring import greedy_color as jcolor
from positionbaseddynamics_tpu_torch.solver.coloring import (
    greedy_color as tcolor)


def _cases():
    rng = np.random.default_rng(0)
    chain = np.stack([np.arange(40), np.arange(1, 41)], axis=1)
    return {
        "chain": chain,
        "chain_reversed": chain[::-1].copy(),
        "random_pairs": rng.integers(0, 30, (200, 2)),
        "random_quads": rng.integers(0, 500, (2000, 4)),
        "dense_triples": rng.integers(0, 8, (60, 3)),
        "one_row": np.array([[3, 7, 9]]),
        "empty": np.zeros((0, 4), np.int32),
    }


@pytest.mark.parametrize("name", list(_cases()))
def test_colors_equal_jax(name):
    idx = _cases()[name]
    tc, tn = tcolor(idx)
    jc, jn = jcolor(idx)
    assert tn == jn
    assert tc.dtype == jc.dtype == np.int32
    np.testing.assert_array_equal(tc, jc)
    for col in range(tn):
        items = [it for row in idx[tc == col] for it in set(row.tolist())]
        assert len(items) == len(set(items)), col
    if name == "chain":
        assert tn == 2
    if name == "empty":
        assert tn == 1 and tc.shape == (0,)
