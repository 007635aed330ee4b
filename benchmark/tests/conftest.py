"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from
the repository's root (``benchmark/pytest.ini`` registers the ``card``
marker). They import neither JAX nor the JAX package."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    """The CUDA device; skips the test without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program's kernels have no CPU "
                    "mode")
    return torch.device("cuda", torch.cuda.current_device())
