"""``examples/torch/joint_demo.py`` at ``tests/test_examples.py``'s 300
steps on the CPU with the JAX demo's check (``test_torch_examples.py``'s
harness): the joint zoo's motors need the whole run to show."""
import pytest
import torch

from test_torch_examples import cases, run_demo


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("script,extra,check", cases(joints=True))
def test_demo_runs(script, extra, check, tmp_path, capsys):
    run_demo(script, extra, check, tmp_path, capsys)
