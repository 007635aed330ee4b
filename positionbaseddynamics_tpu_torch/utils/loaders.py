"""Mesh file ingestion: OBJ, PLY and TetGen models — the port's own numpy
copy of ``positionbaseddynamics_tpu/utils/loaders.py``, so that its
outputs equal JAX's array for array.

Host-side equivalents of the reference's loaders —
``Utils/OBJLoader.h:18+``, ``Utils/PLYLoader.h`` (happly-based),
``Utils/TetGenLoader.{h,cpp}`` (``loadTetgenModel`` for ``.node``/``.ele``
pairs, ``TetGenLoader.cpp:113-190``). Loading happens once at scene-build
time; the device only ever sees the resulting arrays.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def load_obj(path: str) -> dict:
    """Parse a Wavefront OBJ file.

    Returns dict with ``vertices (V, 3) float64``, ``faces (F, 3) int32``
    (polygons fan-triangulated), and optional ``uvs (T, 2)`` /
    ``uv_indices (F, 3)`` / ``normals (N, 3)`` — the fields
    ``Utils/OBJLoader.h`` extracts (positions, texcoords, faces with
    per-corner texture indices)."""
    verts, uvs, normals = [], [], []
    faces, uv_faces = [], []
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                p = line.split()
                verts.append((float(p[1]), float(p[2]), float(p[3])))
            elif line.startswith("vt "):
                p = line.split()
                uvs.append((float(p[1]), float(p[2])))
            elif line.startswith("vn "):
                p = line.split()
                normals.append((float(p[1]), float(p[2]), float(p[3])))
            elif line.startswith("f "):
                corners = line.split()[1:]
                vi, ti = [], []
                for c in corners:
                    parts = c.split("/")
                    vi.append(int(parts[0]))
                    if len(parts) > 1 and parts[1]:
                        ti.append(int(parts[1]))
                nv = len(verts)
                vi = [i - 1 if i > 0 else nv + i for i in vi]
                # fan-triangulate polygons (OBJLoader handles quads the
                # same way)
                for k in range(1, len(vi) - 1):
                    faces.append((vi[0], vi[k], vi[k + 1]))
                    if len(ti) == len(vi):
                        nt = len(uvs)
                        tt = [i - 1 if i > 0 else nt + i for i in ti]
                        uv_faces.append((tt[0], tt[k], tt[k + 1]))
    out = {
        "vertices": np.asarray(verts, np.float64),
        "faces": np.asarray(faces, np.int32).reshape(-1, 3),
    }
    if uvs:
        out["uvs"] = np.asarray(uvs, np.float64)
    if uv_faces and len(uv_faces) == len(faces):
        out["uv_indices"] = np.asarray(uv_faces, np.int32)
    if normals:
        out["normals"] = np.asarray(normals, np.float64)
    return out


# ---------------------------------------------------------------------------
# PLY
# ---------------------------------------------------------------------------

_PLY_TYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def load_ply(path: str) -> dict:
    """Parse a PLY file (ascii or binary_little_endian) — the subset the
    reference consumes through happly (``Utils/PLYLoader.h``): vertex
    x/y/z and face vertex-index lists (fan-triangulated)."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.find(b"end_header")
    if end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    hdr_end = data.find(b"\n", end) + 1
    header = data[:hdr_end].decode("ascii", errors="replace").splitlines()
    body = data[hdr_end:]

    fmt = None
    elements = []  # (name, count, [(prop_name, dtype, list_count_dtype|None)])
    for line in header:
        t = line.split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            elements.append((t[1], int(t[2]), []))
        elif t[0] == "property":
            if t[1] == "list":
                elements[-1][2].append((t[4], _PLY_TYPES[t[3]],
                                        _PLY_TYPES[t[2]]))
            else:
                elements[-1][2].append((t[2], _PLY_TYPES[t[1]], None))

    verts = None
    faces = []
    if fmt == "ascii":
        tokens = body.split()
        pos = 0
        for name, count, props in elements:
            if name == "vertex":
                width = len(props)
                arr = np.asarray(tokens[pos:pos + count * width], np.float64
                                 ).reshape(count, width)
                cols = [p[0] for p in props]
                verts = arr[:, [cols.index("x"), cols.index("y"),
                                cols.index("z")]]
                pos += count * width
            elif name == "face":
                for _ in range(count):
                    n = int(tokens[pos]); pos += 1
                    idx = [int(t) for t in tokens[pos:pos + n]]; pos += n
                    for k in range(1, n - 1):
                        faces.append((idx[0], idx[k], idx[k + 1]))
            else:
                # skip unknown ascii element conservatively (fixed props)
                pos += count * len(props)
    elif fmt == "binary_little_endian":
        off = 0
        for name, count, props in elements:
            if name == "vertex" and all(p[2] is None for p in props):
                dt = np.dtype([(p[0], "<" + p[1]) for p in props])
                arr = np.frombuffer(body, dt, count, off)
                off += dt.itemsize * count
                verts = np.stack([arr["x"], arr["y"], arr["z"]],
                                 -1).astype(np.float64)
            elif name == "face":
                for _ in range(count):
                    cdt = np.dtype("<" + props[0][2])
                    n = int(np.frombuffer(body, cdt, 1, off)[0])
                    off += cdt.itemsize
                    idt = np.dtype("<" + props[0][1])
                    idx = np.frombuffer(body, idt, n, off)
                    off += idt.itemsize * n
                    for k in range(1, n - 1):
                        faces.append((int(idx[0]), int(idx[k]),
                                      int(idx[k + 1])))
            else:
                for _ in range(count):
                    for _, pdt, cnt_dt in props:
                        if cnt_dt is None:
                            off += np.dtype(pdt).itemsize
                        else:
                            n = int(np.frombuffer(
                                body, np.dtype("<" + cnt_dt), 1, off)[0])
                            off += np.dtype(cnt_dt).itemsize
                            off += np.dtype(pdt).itemsize * n
    else:
        raise ValueError(f"{path}: unsupported PLY format {fmt}")
    if verts is None:
        raise ValueError(f"{path}: no vertex element")
    return {"vertices": verts,
            "faces": np.asarray(faces, np.int32).reshape(-1, 3)}


# ---------------------------------------------------------------------------
# TetGen (.node / .ele)
# ---------------------------------------------------------------------------


def _data_lines(path: str):
    with open(path) as f:
        for line in f:
            s = line.strip()
            if s and not s.startswith("#"):
                yield s.split()


def load_tetgen(node_path: str, ele_path: str
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Load a TetGen ``.node``/``.ele`` pair — ``TetGenLoader::
    loadTetgenModel`` (``TetGenLoader.cpp:113-190``). Returns
    ``(vertices (V, 3) float64, tets (T, 4) int32)``; 1-based element
    files are shifted to 0-based using the first node's index."""
    nodes = _data_lines(node_path)
    hdr = next(nodes)
    n_verts = int(hdr[0])
    verts = np.empty((n_verts, 3), np.float64)
    first_index = None
    for i in range(n_verts):
        row = next(nodes)
        if first_index is None:
            first_index = int(row[0])
        verts[i] = [float(row[1]), float(row[2]), float(row[3])]

    eles = _data_lines(ele_path)
    hdr = next(eles)
    n_tets = int(hdr[0])
    tets = np.empty((n_tets, 4), np.int32)
    for i in range(n_tets):
        row = next(eles)
        tets[i] = [int(row[1]), int(row[2]), int(row[3]), int(row[4])]
    if first_index:
        tets -= first_index
    return verts, tets


def load_mesh(path: str) -> dict:
    """Dispatch on extension — the ``DemoBase::loadMesh`` OBJ/PLY split."""
    low = path.lower()
    if low.endswith(".ply"):
        return load_ply(path)
    return load_obj(path)
