"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, at first use, and loaded
with ``ctypes``. All sources are compiled together, one ``nvcc`` process
each. A library's file name carries a hash of its source and flags, so an
edited source is rebuilt and a stale library is never loaded. The build
directory (``build/`` inside this package) is listed in ``.gitignore``.

Nothing here runs when the module is imported: the CPU tests import every
module of the port on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}     # source stem -> nvcc/ptxas output


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source on the machine that has the card")


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every source that has no current library, all at once, and
    load them all. Returns ``{source stem: CDLL}``. Raises RuntimeError
    with the compiler's output if a build fails."""
    with _lock:
        sources = sorted(CSRC.glob("*.cu"))
        pending = []
        for src in sources:
            out = _target(src)
            if src.stem in _libs or out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            pending.append((src, out, tmp, proc))
        failed = []
        for src, out, tmp, proc in pending:
            log, _ = proc.communicate()
            build_logs[src.stem] = log
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed\n" + "\n".join(failed))
        for src in sources:
            if src.stem not in _libs:
                _libs[src.stem] = ctypes.CDLL(str(_target(src)))
        return dict(_libs)


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``."""
    lib = _libs.get(stem)
    if lib is None:
        lib = build_all()[stem]
    return lib
