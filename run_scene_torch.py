#!/usr/bin/env python3
"""Headless scene runner of the PyTorch + CUDA port, beside
``run_scene.py`` (the JAX package's): loads a reference-format scene JSON
on the card, steps it, and optionally exports the particle/rigid
trajectory (npz) or per-frame OBJ meshes (the ``DemoBase`` export path,
``Demos/Common/DemoBase.h:78-95``), with ``run_scene.py``'s flags, lines
and file names.

``--device`` defaults to ``cuda``; without CUDA the script exits 1 unless
given ``--device cpu``, which runs the plain PyTorch route on the CPU.

Examples:
  python3 run_scene_torch.py data/scenes/PileScene.json --steps 200
  python3 run_scene_torch.py scene.json --steps 100 --export-npz traj.npz
  python3 run_scene_torch.py scene.json --steps 80 --export-obj out/ --every 8
  python3 run_scene_torch.py scene.json --device cpu --steps 20
"""
import argparse
import json
import os
import sys
import time


def export_obj(path, verts, faces, uvs=None, uv_indices=None):
    """Write an OBJ frame; ``vt`` + per-corner texture indices when the
    mesh carries them (``IndexedFaceMesh`` m_uvs/m_uvIndices — the
    reference's OBJ export keeps texcoords through skinned vis meshes)."""
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        if uvs is not None and uv_indices is not None:
            for t in uvs:
                f.write(f"vt {t[0]} {t[1]}\n")
            for t, u in zip(faces, uv_indices):
                f.write(f"f {t[0] + 1}/{u[0] + 1} {t[1] + 1}/{u[1] + 1} "
                        f"{t[2] + 1}/{u[2] + 1}\n")
        else:
            for t in faces:
                f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("scene")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--export-npz", default=None,
                    help="save particle/rigid trajectories to this npz")
    ap.add_argument("--export-obj", default=None,
                    help="directory for per-frame OBJ export of tri models")
    ap.add_argument("--every", type=int, default=8,
                    help="export every N steps (reference renders every 8)")
    ap.add_argument("--max-sdf-resolution", type=int, default=None)
    ap.add_argument("--cache-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)

    import numpy as np
    import torch

    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        print("run_scene_torch: CUDA is not available; pass --device cpu to "
              "run the plain PyTorch route on the CPU", file=sys.stderr)
        return 1

    from positionbaseddynamics_tpu_torch._device import resolve_device
    from positionbaseddynamics_tpu_torch.scene import load_scene
    from positionbaseddynamics_tpu_torch.solver import make_step_fn

    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def host(t):
        return t.detach().cpu().numpy()

    t0 = time.perf_counter()
    scene = load_scene(args.scene, cache_dir=args.cache_dir,
                       max_sdf_resolution=args.max_sdf_resolution,
                       device=dev)
    print(f"loaded '{scene.name}': "
          f"{scene.state.particles.x.shape[0]} particles, "
          f"{len(scene.rigid_ids)} rigid bodies, "
          f"{len(scene.tri_models)} tri models, "
          f"{len(scene.tet_models)} tet models "
          f"({time.perf_counter() - t0:.1f}s)")

    fn = make_step_fn(scene.cset, scene.config, dev, pipeline=scene.pipeline)
    state = fn(scene.state)                       # warm-up
    sync()
    t0 = time.perf_counter()

    px_frames, rx_frames, rq_frames = [], [], []
    for i in range(1, args.steps):
        state = fn(state)
        if (args.export_npz or args.export_obj) and i % args.every == 0:
            px_frames.append(host(state.particles.x))
            rx_frames.append(host(state.rigid.x)
                             if state.rigid is not None else None)
            rq_frames.append(host(state.rigid.q)
                             if state.rigid is not None else None)
    sync()
    dt = time.perf_counter() - t0
    print(json.dumps({"steps": args.steps, "wall_s": round(dt, 3),
                      "steps_per_s": round(args.steps / dt, 2)}))

    if args.export_npz:
        out = {"particles_x": np.stack(px_frames) if px_frames else
               np.zeros((0,))}
        if rx_frames and rx_frames[0] is not None:
            out["rigid_x"] = np.stack(rx_frames)
            out["rigid_q"] = np.stack(rq_frames)
        np.savez(args.export_npz, **out)
        print(f"wrote {args.export_npz}")

    if args.export_obj:
        os.makedirs(args.export_obj, exist_ok=True)
        for fi, px in enumerate(px_frames):
            for mid, h in scene.tri_models:
                export_obj(
                    os.path.join(args.export_obj,
                                 f"tri{mid}_frame{fi:04d}.obj"),
                    px[h.offset:h.offset + h.mesh.n_vertices], h.mesh.faces,
                    uvs=h.mesh.uvs, uv_indices=h.mesh.uv_indices)
            for mid, h in scene.tet_models:
                export_obj(
                    os.path.join(args.export_obj,
                                 f"tet{mid}_frame{fi:04d}.obj"),
                    px[h.offset:h.offset + h.mesh.n_vertices],
                    h.mesh.surface_faces)
        print(f"wrote OBJ frames to {args.export_obj}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
