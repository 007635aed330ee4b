"""Every demo of ``examples/torch/`` (the port's copies of ``examples/``)
runs on the CPU at the sizes of ``tests/test_examples.py::DEMOS``, in
this process through its ``main(argv)`` with ``--device cpu``, and
satisfies the JAX demo's own physical check (the check functions are
``test_examples.py``'s, imported). Each script's ``build(args, device)``
gives the scene without running it. The joint demo's 300 steps (about a
minute on the CPU, the rigid route's dispatch) are in
``test_torch_example_joints.py``; the trajectories of three demos and
``run_scene_torch.py`` are held to the JAX scripts' in
``test_torch_example_parity.py``."""
import os
import sys

import numpy as np
import pytest
import torch

from test_examples import DEMOS

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
EXAMPLES = os.path.join(ROOT, "examples", "torch")


def common():
    """``examples/torch/_common.py``, the demos' harness."""
    if EXAMPLES not in sys.path:
        sys.path.insert(0, EXAMPLES)
    import _common
    return _common


def load_example(name):
    """``examples/torch/<name>`` (``name`` ends in ``.py``) loaded by
    ``_common.load_example``."""
    return common().load_example(name[:-3])


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_every_demo_has_its_port():
    jax_demos = sorted(f for f in os.listdir(os.path.join(ROOT, "examples"))
                       if f.endswith("_demo.py"))
    assert len(jax_demos) == 15
    assert sorted(f for f in os.listdir(EXAMPLES)
                  if f.endswith("_demo.py")) == jax_demos
    for name in jax_demos:
        assert callable(load_example(name).build), name


def cases(joints):
    """``DEMOS`` with its ids, the joint demo's alone or the others."""
    return [pytest.param(*c, id=f"{c[0]}-{i}") for i, c in enumerate(DEMOS)
            if (c[0] == "joint_demo.py") == joints]


def run_demo(script, extra, check, tmp_path, capsys):
    """``main`` of the demo at ``extra`` with ``--device cpu``, its
    trajectory held to ``check``."""
    npz = str(tmp_path / "traj.npz")
    code = load_example(script).main(list(extra) + [
        "--device", "cpu", "--export-npz", npz])
    out = capsys.readouterr().out
    assert code == 0, out
    assert "finite: True" in out or "steps/s" in out, out
    with np.load(npz) as t:
        check(dict(t))


@pytest.mark.parametrize("script,extra,check", cases(joints=False))
def test_demo_runs(script, extra, check, tmp_path, capsys):
    run_demo(script, extra, check, tmp_path, capsys)


def test_demo_refuses_cuda_without_it(capsys):
    if torch.cuda.is_available():
        pytest.skip("the card is present")
    with pytest.raises(SystemExit) as e:
        load_example("chain_demo.py").main(["--steps", "1"])
    assert e.value.code == 1
    assert "--device cpu" in capsys.readouterr().err


def test_build_gives_the_scene_without_running():
    d = common().build_demo(load_example("bar_demo.py"),
                          ["--dims", "5", "3", "3"], "cpu")
    assert d.state.particles.n == 45 and d.cset.grid_tets
    d = common().build_demo(load_example("stiff_rods_demo.py"), ["--tree"],
                          "cpu")
    assert d.info["tree"] and d.state.rigid.n == 4
