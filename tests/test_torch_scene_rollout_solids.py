"""Loaded scenes without rigid contacts stepped by both packages on the
CPU (``test_torch_scene_rollout.py``'s comparison): two TetGen models
with their solid–solid contacts over the floor, every joint section, and
the stiff-rod Y-tree and chain, 20 steps within 1e-4."""
import pytest
import torch

import torch_scene_files as files
from test_torch_scene_loader import load_both
from test_torch_scene_rollout import STEPS, TOL, roll


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("scene", ["two_tets", "joints", "y_tree", "chain"])
def test_loaded_scene_rollout(tmp_path, scene):
    data, base = getattr(files, scene)(str(tmp_path))
    t, j = load_both(data, base, str(tmp_path / "cache"))
    devs, parted, _, path = roll(t, j, t.pipeline, j.pipeline)
    print(f"{scene}: max dev {devs.max()!r}, active sets part at {parted}")
    assert path == "torch_rigid"
    assert parted is None
    assert len(devs) == STEPS
    assert devs.max() <= TOL, devs.max()
