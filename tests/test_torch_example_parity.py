"""The port's demo scripts and scene runner against the JAX package's on
the CPU: ``cloth_demo``, ``bar_demo`` and ``chain_demo`` at
``tests/test_examples.py``'s sizes, the JAX script run as that test runs
it (a subprocess under ``JAX_PLATFORMS=cpu``) and the port's in this
process, their exported trajectories within 1e-4 (``BASELINE.md``'s
end-to-end bar); and ``run_scene_torch.py`` against ``run_scene.py`` on
the cloth stand-in at 6×6 (npz within 1e-4, the same OBJ frames with
``vt`` lines and ``f v/vt`` corners)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench_torch
from test_torch_examples import ROOT, load_example

TOL = 1e-4


def _jax(args, cwd, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable] + args, cwd=cwd, capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    return r.stdout


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("script,extra", [
    ("cloth_demo.py", ["--n", "12", "--steps", "30"]),
    ("bar_demo.py", ["--dims", "8", "3", "3", "--steps", "30"]),
    ("chain_demo.py", ["--links", "4", "--steps", "40"])])
def test_demo_trajectory_matches_jax(script, extra, tmp_path, capsys):
    jnpz, tnpz = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jout = _jax([script] + extra + ["--export-npz", jnpz],
                os.path.join(ROOT, "examples"), tmp_path)
    assert load_example(script).main(
        extra + ["--device", "cpu", "--export-npz", tnpz]) == 0
    tout = capsys.readouterr().out
    with np.load(jnpz) as j, np.load(tnpz) as t:
        assert sorted(t.files) == sorted(j.files)
        for k in j.files:
            assert t[k].shape == j[k].shape, k
            dev = np.abs(t[k] - j[k]).max()
            print(f"{script} {k}: max dev {dev!r}")
            assert dev <= TOL, (k, dev)
    # the same summary lines apart from the timing
    def lines(out):
        return [line for line in out.splitlines() if "steps in" not in line
                and not line.startswith("trajectory saved")]
    assert len(lines(tout)) == len(lines(jout))
    assert [line.split(":")[0] for line in lines(tout)] == \
        [line.split(":")[0] for line in lines(jout)]


def test_run_scene_torch_matches_run_scene(tmp_path):
    path = bench_torch.write_cloth_scene(str(tmp_path / "files"), n=6,
                                         xpbd=True)
    common = ["--steps", "20", "--every", "4", "--max-sdf-resolution",
              "10", "--cache-dir", str(tmp_path / "cache")]
    jout = _jax(["run_scene.py", path, "--export-npz",
                 str(tmp_path / "j.npz"), "--export-obj",
                 str(tmp_path / "jo")] + common, ROOT, tmp_path)
    r = subprocess.run(
        [sys.executable, "run_scene_torch.py", path, "--export-npz",
         str(tmp_path / "t.npz"), "--export-obj", str(tmp_path / "to"),
         "--device", "cpu"] + common, cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    tout = r.stdout
    assert tout.splitlines()[0].split("(")[0] == \
        jout.splitlines()[0].split("(")[0]          # the "loaded" line
    assert '"steps_per_s"' in tout.splitlines()[1]
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        assert sorted(t.files) == sorted(j.files) == [
            "particles_x", "rigid_q", "rigid_x"]
        for k in j.files:
            assert np.abs(t[k] - j[k]).max() <= TOL, k
    frames = sorted(os.listdir(tmp_path / "jo"))
    assert frames == sorted(os.listdir(tmp_path / "to"))
    assert frames == [f"tri0_frame{i:04d}.obj" for i in range(4)]
    for name in frames:
        jt = (tmp_path / "jo" / name).read_text().splitlines()
        tt = (tmp_path / "to" / name).read_text().splitlines()
        assert len(tt) == len(jt)
        assert sum(line.startswith("vt ") for line in tt) == 36
        for a, b in zip(tt, jt):
            assert a.split()[0] == b.split()[0]
            if a.startswith("v "):
                assert np.abs(np.float64(a.split()[1:])
                              - np.float64(b.split()[1:])).max() <= TOL
            else:
                assert a == b                    # vt and f v/vt lines


def test_run_scene_torch_refuses_cuda_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the card is present")
    import run_scene_torch

    path = bench_torch.write_cloth_scene(str(tmp_path), n=4)
    assert run_scene_torch.main([path, "--steps", "2"]) == 1
