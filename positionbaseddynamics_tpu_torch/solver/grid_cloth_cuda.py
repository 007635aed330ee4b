"""Fused XPBD cloth substep as a hand-written CUDA kernel for Hopper —
the counterpart of ``positionbaseddynamics_tpu/solver/grid_cloth_pallas.py``
(``make_pallas_cloth_step``).

One launch of ``csrc/grid_cloth_step.cu`` runs one substep of a regular
H×W XPBD cloth for every rollout of a batch: integrate, ``max_iterations``
Jacobi passes of the 3 distance and the 3 rank-1 isometric-bending
families, velocity update, damping. A substep of more than
``FUSED_ITERATIONS`` iterations takes one launch for each such share of
them. The state travels as component planes
``(B, 3, H, W)``: :func:`make_cloth_step` converts ``(x, v)`` to planes once
per call and back once at the end.

Two modes of the TPU kernel are here too. **Fused** (``fuse_substeps``,
:func:`cloth_fused_cuda`): one cooperative launch runs whole substeps, up
to ``FUSED_PASSES`` iterations × substeps, so a step of 5 substeps at one
iteration is one launch. Its grid is as many blocks as the card holds at
once (:func:`fused_capacity`), each taking (tile, rollout) items in grid
stride; a pass runs a one-iteration launch's code on each item, with the
halo of one pass, and the grid synchronises between passes. The state
between passes lives in scratch planes that the step function allocates
once (:class:`FusedScratch`). A pass computes what a per-substep launch
computes, so the two modes agree bit for bit. **Row window**
(``height_override``, ``global_height``, ``external_params``,
:func:`cloth_window_cuda` and the row offset of
:func:`cloth_substep_cuda`): the kernel steps a window of a taller grid's
rows, its masks and parity from the global row, the inverse masses and
Jacobi weights given per call; ``parallel/intra_cuda.py`` runs a rank's
rows so, through the fused kernel. A card without cooperative launch, or
a launch that fails, raises; nothing falls back to the per-substep
launches.

Beside the kernel sit its plain PyTorch versions:
:func:`cloth_substep_reference`, composed of the ported integration
functions and :meth:`GridClothBatch.project` (fused: one call a substep),
and ``grid_window.window_substeps_reference`` for the row window. The CPU
tests run them, and the card's smoke run holds the kernel against them.
The step function that :func:`make_cloth_step` returns takes the plain
versions for CPU tensors only; for CUDA tensors it launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .. import _build
from .._device import resolve_device
from ..ops import integration
from .grid_cloth import _DIST_FAMILIES, GridClothBatch, _helper_grid
from .grid_window import window_substeps_reference

Tensor = torch.Tensor

N_PARAMS = 40                   # floats in the kernel's Params struct
# Iterations one launch holds, one template instance of the kernel each: a
# 32×16 tile with its halo of 3·iterations takes 116 KB of shared memory
# and 115 registers a thread at 4. A substep with more iterations takes
# several launches, which carry the positions and λ between them.
FUSED_ITERATIONS = 4
# Iterations × substeps one fused launch runs; a step of more passes takes
# launches of fewer substeps each.
FUSED_PASSES = 5
# A block's tile, (width, height) (``TX``, ``TY`` of the kernel source): a
# fused launch's items are (tile, rollout) pairs.
TILE = (32, 16)
_BEND_ORDER = ("bh", "bv", "bd")


def _family_rest(batch: GridClothBatch, fam) -> Optional[float]:
    r = batch.rest[fam]
    return float(r) if r.dim() == 0 else None


def _family_svec(batch: GridClothBatch, fam):
    """Rank-1 bending S vectors of a family as ``(S where helper = 1,
    S where helper = 0)``, or None when a parity class is not uniform
    (``grid_cloth_pallas.py:67-99``). On a regular grid the stencils of a
    family fall into two congruence classes, mirror images across the
    quad diagonal."""
    s = batch.q_mat[fam].detach().cpu().numpy().astype(np.float32)
    if s.ndim == 1:
        sv = [float(v) for v in s]
        return sv, sv
    h, w = batch.height, batch.width
    helper = np.zeros((h, w), bool)
    helper[:h - 1, :w - 1] = _helper_grid(h, w)
    par = {"bh": helper[1:h - 1, :w - 1], "bv": helper[:h - 1, 1:w - 1],
           "bd": helper[:h - 1, :w - 1]}[fam]
    if par.shape != s.shape[:2]:
        return None
    out = []
    for m in (par, ~par):
        rows = s[m]
        if rows.size == 0:
            out.append([0.0, 0.0, 0.0, 0.0])
            continue
        mean = rows.mean(axis=0, dtype=np.float64)
        if not np.all(np.abs(rows - mean)
                      <= 1e-4 * np.maximum(np.abs(mean), 1e-12) + 1e-6):
            return None
        out.append([float(v) for v in mean])
    return out[0], out[1]


def unsupported_reason(batch: GridClothBatch) -> Optional[str]:
    """Why the kernel cannot run this batch, or None when it can. The
    same preconditions as the TPU kernel (``grid_cloth_pallas.py:58-99,
    166-171``)."""
    if batch.offset != 0:
        return "the cloth kernel expects the cloth at particle offset 0"
    if not (batch.has_distance and batch.has_bending):
        return "the cloth kernel expects distance and bending families"
    if not (batch.xpbd_distance and batch.xpbd_bending):
        return "the cloth kernel runs XPBD families only"
    if any(_family_rest(batch, f) is None for f in _DIST_FAMILIES):
        return "the cloth kernel requires uniform rest lengths"
    if any(f not in batch.q_mat or _family_svec(batch, f) is None
           for f in _BEND_ORDER):
        return ("the cloth kernel requires per-parity-uniform bending "
                "stencils")
    return None


def _alpha(stiff: float, h: np.float32) -> np.float32:
    """XPBD compliance ``1/(k·h²)`` in float32, in the order the plain
    version computes it; 0 where ``k = 0``."""
    k = np.float32(stiff)
    return np.float32(0.0) if k == 0 else np.float32(1.0) / (k * h * h)


def kernel_params(batch: GridClothBatch, *, h: float, gravity=(0.0, -9.81, 0.0),
                  damping: float = 0.0) -> np.ndarray:
    """The kernel's host-side scalars as ``N_PARAMS`` float32 values, in
    the layout of ``struct Params`` in ``csrc/grid_cloth_step.cu``. Raises
    NotImplementedError for a batch the kernel cannot run."""
    reason = unsupported_reason(batch)
    if reason is not None:
        raise NotImplementedError(reason)
    h32 = np.float32(h)
    p = np.zeros((N_PARAMS,), np.float32)
    p[0:3] = [_family_rest(batch, f) for f in _DIST_FAMILIES]
    p[3:6] = [_alpha(float(batch.stiff[f]), h32) for f in _DIST_FAMILIES]
    svec = [_family_svec(batch, f) for f in _BEND_ORDER]
    p[6:18] = np.ravel([se for se, _ in svec])
    p[18:30] = np.ravel([so for _, so in svec])
    p[30:33] = [_alpha(float(batch.bend_stiff[f]), h32) for f in _BEND_ORDER]
    p[33] = h32
    p[34:37] = np.asarray(gravity, np.float32)
    p[37] = np.float32(1.0 - damping)
    p[38] = 1.0 if damping else 0.0
    return p


def to_planes(a: Tensor, height: int, width: int) -> Tensor:
    """``(..., H·W, 3)`` → contiguous component planes ``(B, 3, H, W)``."""
    return a.reshape(-1, height, width, 3).permute(0, 3, 1, 2).contiguous()


def from_planes(p: Tensor, lead) -> Tensor:
    """Component planes ``(B, 3, H, W)`` → ``lead + (H·W, 3)``."""
    return p.permute(0, 2, 3, 1).reshape(*lead, -1, 3)


def _bind(lib):
    fn = lib.pbd_cloth_substep
    if getattr(fn, "_pbd_bound", False):
        return fn
    vp = ctypes.c_void_p
    fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ctypes.c_longlong, vp,
                   vp, vp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, vp]
    fn.restype = ctypes.c_int
    lib.pbd_error_string.argtypes = [ctypes.c_int]
    lib.pbd_error_string.restype = ctypes.c_char_p
    fused = lib.pbd_cloth_fused
    # x_in v_in x_out v_out xs vs xp0 xp1 lam0 lam1 w w_bstride icd icb
    # params n_batch height width iters substeps row_offset global_height
    # grid_size stream
    fused.argtypes = [vp] * 11 + [ctypes.c_longlong, vp, vp, vp] + \
        [ctypes.c_int] * 7 + [vp, vp]
    fused.restype = ctypes.c_int
    for name in ("pbd_cloth_param_count", "pbd_cloth_max_iterations",
                 "pbd_cloth_max_passes"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.pbd_cloth_kernel_resources.argtypes = [ctypes.c_int, vp]
    lib.pbd_cloth_kernel_resources.restype = ctypes.c_int
    for name in ("pbd_cloth_fused_resources", "pbd_cloth_fused_capacity"):
        getattr(lib, name).argtypes = [vp]
        getattr(lib, name).restype = ctypes.c_int
    if (lib.pbd_cloth_param_count() != N_PARAMS
            or lib.pbd_cloth_max_iterations() != FUSED_ITERATIONS
            or lib.pbd_cloth_max_passes() != FUSED_PASSES):
        raise RuntimeError("grid_cloth_step.cu and grid_cloth_cuda.py "
                           "disagree on the kernel's parameter layout or "
                           "iterations per launch")
    fn._pbd_bound = True
    return fn


def kernel_resources(fused: bool = False) -> dict:
    """The kernel's resources as the CUDA runtime reports them on the
    current card, for each iteration count one launch holds (one template
    instance each): ``{iters: {"registers", "static_shared_bytes",
    "dynamic_shared_bytes", "local_bytes", "blocks_per_sm",
    "threads"}}``; with ``fused`` the one dict of the fused kernel."""
    lib = _build.load("grid_cloth_step")
    _bind(lib)
    if fused:
        return fused_resources_of(lib)
    return {iters: resources_of(lib, iters)
            for iters in range(1, FUSED_ITERATIONS + 1)}


RESOURCE_KEYS = ("registers", "static_shared_bytes", "dynamic_shared_bytes",
                 "local_bytes", "blocks_per_sm", "threads")


def _resources(lib, fn, *args) -> dict:
    vals = (ctypes.c_int * len(RESOURCE_KEYS))()
    err = fn(*args, vals)
    if err != 0:
        raise RuntimeError("cloth kernel resources: "
                           + lib.pbd_error_string(err).decode())
    return dict(zip(RESOURCE_KEYS, vals))


def resources_of(lib, iters: int) -> dict:
    """:func:`kernel_resources` of one iteration count, from a library
    built from ``csrc/grid_cloth_step.cu`` or from a variant of it."""
    return _resources(lib, lib.pbd_cloth_kernel_resources, iters)


def fused_resources_of(lib) -> dict:
    """:func:`kernel_resources` of the fused kernel, from a library built
    from ``csrc/grid_cloth_step.cu`` or from a variant of it."""
    return _resources(lib, lib.pbd_cloth_fused_resources)


def fused_capacity() -> int:
    """The fused launch's largest grid on the current card: the blocks it
    holds at once (blocks an SM × SMs). Raises on a card without
    cooperative launch."""
    lib = _build.load("grid_cloth_step")
    _bind(lib)
    cap = ctypes.c_int(0)
    err = lib.pbd_cloth_fused_capacity(ctypes.byref(cap))
    if err != 0:
        raise RuntimeError("cloth fused capacity: "
                           + lib.pbd_error_string(err).decode())
    return cap.value


def fused_items(n_batch: int, height: int, width: int) -> int:
    """The (tile, rollout) items of a fused launch: each pass runs one
    :data:`TILE` of one rollout an item."""
    return n_batch * -(-height // TILE[1]) * -(-width // TILE[0])


def fused_grid(n_batch: int, height: int, width: int, capacity: int) -> int:
    """Blocks of a fused launch on a card that holds ``capacity`` at once
    (:func:`fused_capacity`): one an item, at most ``capacity``; a block
    takes the items in grid stride, ``ceil(items / grid)`` or one fewer a
    pass."""
    return min(fused_items(n_batch, height, width), capacity)


def _ptr(t: Optional[Tensor]):
    return None if t is None else t.data_ptr()


def _check_planes(xp: Tensor, vp: Tensor, w: Tensor, icd: Tensor,
                  icb: Tensor, params: np.ndarray, what: str):
    """The checks every launch makes. Returns ``(params as float32,
    w_bstride)``."""
    if xp.device.type != "cuda":
        raise ValueError(f"{what} takes CUDA tensors; the plain versions "
                         "are cloth_substep_reference and "
                         "grid_window.window_substeps_reference")
    if xp.dim() != 4 or xp.shape[1] != 3 or vp.shape != xp.shape:
        raise ValueError(f"expected (B, 3, H, W) planes, got {tuple(xp.shape)}"
                         f" and {tuple(vp.shape)}")
    b, _, h, wd = xp.shape
    if w.dim() == 2:
        w_bstride = 0
    elif w.dim() == 3 and w.shape[0] == b:
        w_bstride = h * wd
    else:
        raise ValueError(f"inverse-mass plane {tuple(w.shape)} does not fit "
                         f"{b} rollouts")
    for name, t in (("x", xp), ("v", vp), ("w", w), ("icd", icd),
                    ("icb", icb)):
        if t.device != xp.device or t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 on {xp.device}, got "
                             f"{t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if tuple(t.shape[-2:]) != (h, wd):
            raise ValueError(f"{name}: plane shape {tuple(t.shape)} is not "
                             f"(..., {h}, {wd})")
    params = np.ascontiguousarray(params, np.float32)
    if params.shape != (N_PARAMS,):
        raise ValueError(f"params: expected ({N_PARAMS},), got {params.shape}")
    return params, w_bstride


def _raise_on(lib, err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.pbd_error_string(err).decode())


def cloth_substep_cuda(xp: Tensor, vp: Tensor, w: Tensor, icd: Tensor,
                       icb: Tensor, params: np.ndarray,
                       max_iterations: int = 1, row_offset: int = 0,
                       global_height: Optional[int] = None):
    """Run one substep through the fused kernel: one launch for up to
    ``FUSED_ITERATIONS`` iterations, one more for each further such share.
    ``xp``, ``vp``: ``(B, 3, H, W)`` float32 planes on one CUDA device;
    ``w``: inverse masses ``(H, W)`` shared by the rollouts or ``(B, H,
    W)``; ``icd``, ``icb``: ``(H, W)`` Jacobi weights; ``params`` from
    :func:`kernel_params`. The H rows are rows ``row_offset..`` of a grid
    of ``global_height`` rows (default: the whole grid, H). Returns new
    ``(xp, vp)`` buffers; the inputs are left as they were. Counts its
    launches in ``cloth_substep_cuda.launches``."""
    params, w_bstride = _check_planes(xp, vp, w, icd, icb, params,
                                      "cloth_substep_cuda")
    b, _, h, wd = xp.shape
    gh = h if global_height is None else int(global_height)
    if max_iterations < 1:
        raise ValueError(f"max_iterations={max_iterations}: at least 1")
    lib = _build.load("grid_cloth_step")
    fn = _bind(lib)
    x_cur = lam = vo = None
    left = max_iterations
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        while left:
            k = min(left, FUSED_ITERATIONS)
            left -= k
            xo = torch.empty_like(xp)
            if left:
                lam_out = xp.new_empty((b, 6, h, wd))
            else:
                lam_out, vo = None, torch.empty_like(vp)
            err = fn(xp.data_ptr(), vp.data_ptr(), _ptr(x_cur), _ptr(lam),
                     xo.data_ptr(), _ptr(vo), _ptr(lam_out), w.data_ptr(),
                     w_bstride, icd.data_ptr(), icb.data_ptr(),
                     params.ctypes.data, b, h, wd, k, int(row_offset), gh,
                     stream)
            _raise_on(lib, err, "cloth substep")
            cloth_substep_cuda.launches += 1
            x_cur, lam = xo, lam_out
    return x_cur, vo


cloth_substep_cuda.launches = 0


def fused_split(substeps: int, max_iterations: int) -> list:
    """The substeps of each fused launch of one step: as many whole
    substeps as ``FUSED_PASSES`` holds at ``max_iterations``, the rest in
    the last. Raises NotImplementedError where one substep does not fit."""
    if not 1 <= max_iterations <= FUSED_PASSES:
        raise NotImplementedError(
            f"the fused cloth kernel holds at most {FUSED_PASSES} "
            f"iterations a launch, not {max_iterations}; use "
            "fuse_substeps=False")
    k = FUSED_PASSES // max_iterations
    return [min(k, substeps - s) for s in range(0, substeps, k)]


class FusedScratch:
    """The fused launch's scratch planes, allocated at the first launch
    that needs each and kept for every later one of the same planes: a
    state ``(xs, vs)`` like the step's planes past one substep, positions
    between a substep's passes and a λ plane ``(B, 6, H + 2, W)`` past one
    iteration (a second of each past two). λ holds a row above and below
    the planes' rows: a row window's anchors there reach into its first
    and last rows. The launch leaves them undefined, so one scratch serves
    launches in turn on one stream."""

    NAMES = ("xs", "vs", "xp0", "xp1", "lam0", "lam1")

    def __init__(self):
        self._key = None
        self.bufs = {}

    def get(self, xp: Tensor, substeps: int, iterations: int):
        """The buffers of :data:`NAMES` for a launch of ``substeps``
        substeps of ``iterations`` on planes like ``xp``, None where it
        needs no such buffer."""
        key = (xp.device, tuple(xp.shape))
        if key != self._key:
            self._key, self.bufs = key, {}
        need = {"xs": substeps > 1, "vs": substeps > 1,
                "xp0": iterations > 1, "xp1": iterations > 2,
                "lam0": iterations > 1, "lam1": iterations > 2}
        out = []
        for name in self.NAMES:
            if need[name] and name not in self.bufs:
                shape = xp.shape
                if name.startswith("lam"):
                    shape = (xp.shape[0], 6, xp.shape[2] + 2, xp.shape[3])
                self.bufs[name] = xp.new_empty(shape)
            out.append(self.bufs[name] if need[name] else None)
        return tuple(out)


def _fused(xp, vp, w, icd, icb, params, max_iterations, substeps,
           row_offset, global_height, scratch, what):
    """``substeps`` substeps in the launches of :func:`fused_split`.
    Returns ``(xp, vp, launches, grid)``, ``grid`` the last launch's grid
    size."""
    params, w_bstride = _check_planes(xp, vp, w, icd, icb, params, what)
    b, _, h, wd = xp.shape
    split = fused_split(substeps, max_iterations)
    lib = _build.load("grid_cloth_step")
    _bind(lib)
    scratch = scratch or FusedScratch()
    grid = ctypes.c_int(0)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        for n in split:
            bufs = scratch.get(xp, n, max_iterations)
            xo, vo = torch.empty_like(xp), torch.empty_like(vp)
            err = lib.pbd_cloth_fused(
                xp.data_ptr(), vp.data_ptr(), xo.data_ptr(), vo.data_ptr(),
                *(_ptr(t) for t in bufs), w.data_ptr(), w_bstride,
                icd.data_ptr(), icb.data_ptr(), params.ctypes.data, b, h, wd,
                max_iterations, n, int(row_offset), int(global_height),
                ctypes.byref(grid), stream)
            _raise_on(lib, err, what)
            xp, vp = xo, vo
    return xp, vp, len(split), grid.value


def cloth_fused_cuda(xp: Tensor, vp: Tensor, w: Tensor, icd: Tensor,
                     icb: Tensor, params: np.ndarray, max_iterations: int,
                     substeps: int, scratch: Optional[FusedScratch] = None):
    """Run ``substeps`` whole substeps through the fused kernel, as many a
    launch as ``FUSED_PASSES`` holds (one launch for 5 substeps at one
    iteration), the counterpart of ``fuse_substeps``. Arguments as
    :func:`cloth_substep_cuda`'s; ``scratch`` keeps the launches' scratch
    planes between calls (a fresh one when None). Returns new ``(xp, vp)``
    buffers and leaves the inputs as they were. Counts its launches in
    ``cloth_fused_cuda.launches`` and keeps the last launch's grid size in
    ``cloth_fused_cuda.grid``."""
    xp, vp, n, grid = _fused(xp, vp, w, icd, icb, params, max_iterations,
                             substeps, 0, xp.shape[-2], scratch,
                             "cloth_fused_cuda")
    cloth_fused_cuda.launches += n
    cloth_fused_cuda.grid = grid
    return xp, vp


cloth_fused_cuda.launches = 0
cloth_fused_cuda.grid = None


def cloth_window_cuda(xp: Tensor, vp: Tensor, w: Tensor, icd: Tensor,
                      icb: Tensor, params: np.ndarray, max_iterations: int,
                      substeps: int, row_offset: int, global_height: int,
                      scratch: Optional[FusedScratch] = None):
    """:func:`cloth_fused_cuda` on a window of rows: the H rows of the
    planes are rows ``row_offset..`` (negative above the grid) of a grid of
    ``global_height`` rows, and rows beyond the window count as zeros of
    zero inverse mass. Counts its launches in
    ``cloth_window_cuda.launches`` and keeps the last launch's grid size
    in ``cloth_window_cuda.grid``."""
    xp, vp, n, grid = _fused(xp, vp, w, icd, icb, params, max_iterations,
                             substeps, row_offset, global_height, scratch,
                             "cloth_window_cuda")
    cloth_window_cuda.launches += n
    cloth_window_cuda.grid = grid
    return xp, vp


cloth_window_cuda.launches = 0
cloth_window_cuda.grid = None


def run_substeps(xp: Tensor, vp: Tensor, w: Tensor, icd: Tensor,
                 icb: Tensor, params: np.ndarray, max_iterations: int,
                 n: int):
    """``n`` substeps through :func:`cloth_substep_cuda`. Returns the final
    ``(xp, vp)`` planes and the inputs of the last and of the second-last
    substep (``old_x`` and ``last_x`` of the stepper), None where there
    was no such substep."""
    old = last = None
    for _ in range(n):
        last, old = old, xp
        xp, vp = cloth_substep_cuda(xp, vp, w, icd, icb, params,
                                    max_iterations)
    return xp, vp, old, last


def cloth_substep_reference(batch: GridClothBatch, x: Tensor, v: Tensor,
                            inv_mass: Tensor, *, h: float,
                            max_iterations: int = 1,
                            gravity=(0.0, -9.81, 0.0), damping: float = 0.0):
    """The kernel's plain PyTorch version: one substep of ``_substep`` for
    a scene that is this grid cloth alone, Jacobi with ``omega = 1``.
    ``x``, ``v``: ``(..., N, 3)``; returns ``(x, v)``."""
    g = torch.as_tensor(gravity, dtype=torch.float32, device=x.device)
    xn, vn = integration.semi_implicit_euler(h, inv_mass, x, v,
                                             g.expand_as(x))
    lams = batch.init_lambda()
    for _ in range(max_iterations):
        xn, lams = batch.project(xn, inv_mass, lams, h)
    vn = integration.velocity_update_first_order(h, inv_mass, xn, x, vn)
    if damping:
        vn = vn * (1.0 - damping)
    return xn, vn


def make_cloth_step(batch: GridClothBatch, inv_mass, inv_cnt_dist,
                    inv_cnt_bend, *, dt: float, substeps: int,
                    max_iterations: int = 1, gravity=(0.0, -9.81, 0.0),
                    damping: float = 0.0, n_batch: int = 1, n_steps: int = 1,
                    fuse_substeps: bool = False,
                    height_override: Optional[int] = None,
                    global_height: Optional[int] = None,
                    external_params: bool = False, device=None):
    """Build ``step(x, v) -> (x, v)`` that advances ``n_steps·substeps``
    substeps, the counterpart of ``make_pallas_cloth_step``. ``x``, ``v``
    are ``(N, 3)``, or ``(n_batch, N, 3)`` when ``n_batch > 1``; the
    rollouts share every parameter. The batch must cover particles
    ``[0, H·W)`` with uniform XPBD parameters, as for the TPU kernel.

    ``fuse_substeps`` runs a step's substeps in :func:`fused_split`'s
    cooperative launches (one at 5 substeps of one iteration), their
    scratch planes allocated once for the step function, else one launch
    a substep (two past ``FUSED_ITERATIONS`` iterations). The row-window mode
    (``grid_cloth_pallas.py:161, 221, 554``): the step works on
    ``height_override`` rows, masks and parity from a grid of
    ``global_height`` rows (default: the window's own); with
    ``external_params`` it is ``step(x, v, w, icd, icb, row_offset)``, the
    inverse masses and Jacobi weights given per call as ``(rows·W,)`` and
    the window's first row as a global row, and ``inv_mass``,
    ``inv_cnt_dist`` and ``inv_cnt_bend`` are not read.

    On ``device`` (None means CUDA) the step launches the kernel; given CPU
    tensors it runs the plain versions (:func:`cloth_substep_reference`, or
    ``grid_window.window_substeps_reference`` in the row-window mode)."""
    dev = resolve_device(device)
    wid = batch.width
    hgt = batch.height if height_override is None else int(height_override)
    gh = hgt if global_height is None else int(global_height)
    windowed = (height_override is not None or global_height is not None
                or external_params)
    n = hgt * wid
    h = dt / substeps
    params = kernel_params(batch, h=h, gravity=gravity, damping=damping)
    if max_iterations < 1:
        raise ValueError(f"max_iterations={max_iterations}: at least 1")
    if fuse_substeps:
        fused_split(substeps, max_iterations)       # refuses what cannot fit
    if batch.device != dev:
        batch = batch.to(dev)

    def plane(a, name):
        t = torch.as_tensor(a, dtype=torch.float32, device=dev)
        if t.numel() != n:
            raise ValueError(f"{name}: {t.numel()} values for a "
                             f"{hgt}x{wid} cloth")
        return t.reshape(hgt, wid).contiguous()

    shape = (n, 3) if n_batch == 1 else (n_batch, n, 3)
    n_sub = n_steps * substeps
    scratch = FusedScratch()

    def run(x, v, w, icd, icb, off):
        if tuple(x.shape) != shape or tuple(v.shape) != shape:
            raise ValueError(f"expected x, v of shape {shape}, got "
                             f"{tuple(x.shape)} and {tuple(v.shape)}")
        if x.device != dev or v.device != dev:
            raise ValueError(f"step was built for {dev}; got tensors on "
                             f"{x.device} and {v.device}")
        lead = x.shape[:-2]
        if dev.type == "cuda":
            xp, vp = to_planes(x, hgt, wid), to_planes(v, hgt, wid)
            if not fuse_substeps:
                for _ in range(n_sub):
                    xp, vp = cloth_substep_cuda(xp, vp, w, icd, icb, params,
                                                max_iterations, off, gh)
            elif windowed:
                for _ in range(n_steps):
                    xp, vp = cloth_window_cuda(xp, vp, w, icd, icb, params,
                                               max_iterations, substeps, off,
                                               gh, scratch)
            else:
                for _ in range(n_steps):
                    xp, vp = cloth_fused_cuda(xp, vp, w, icd, icb, params,
                                              max_iterations, substeps,
                                              scratch)
            return from_planes(xp, lead), from_planes(vp, lead)
        if windowed:
            def grid(a):
                return a.reshape(*lead, hgt, wid, 3)

            x, v = window_substeps_reference(
                params, grid(x), grid(v), w[..., None], icd[..., None],
                icb[..., None], row_offset=int(off), global_height=gh,
                max_iterations=max_iterations, n=n_sub)
            return x.reshape(shape), v.reshape(shape)
        w_flat = w.reshape(n)
        for _ in range(n_sub):
            x, v = cloth_substep_reference(
                batch, x, v, w_flat, h=h, max_iterations=max_iterations,
                gravity=gravity, damping=damping)
        return x, v

    if external_params:
        def step(x: Tensor, v: Tensor, w, icd, icb, row_offset: int):
            return run(x, v, plane(w, "w"), plane(icd, "icd"),
                       plane(icb, "icb"), row_offset)

        return step

    w = plane(inv_mass, "inv_mass")
    icd = plane(inv_cnt_dist, "inv_cnt_dist")
    icb = plane(inv_cnt_bend, "inv_cnt_bend")

    def step(x: Tensor, v: Tensor):
        return run(x, v, w, icd, icb, 0)

    return step
