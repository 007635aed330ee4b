"""Fused XPBD FEM-tet substep as a hand-written CUDA kernel for Hopper —
the counterpart of ``positionbaseddynamics_tpu/solver/grid_tet_pallas.py``
(``make_pallas_tet_step``).

A substep of a regular W×H×D tet grid runs as one launch of
``csrc/grid_tet_step.cu`` per Jacobi iteration (:func:`tet_substep_cuda`,
``tet_substep_kernel<0>``). A block stages a box of
vertices with a one-vertex halo in shared memory, solves the 5 tets of
every hex cell that touches the box (warps of one cell parity), gathers
the corrections corner by corner in the plain version's order and writes
the box's new positions. The first launch of a substep integrates the
positions it stages; the last updates the velocity and applies the
damping. At more than one iteration λ travels between the launches in two
``(5, cells)`` planes, read from one and written to the other. The state
travels as component planes ``(3, W·H·D)``: :func:`make_tet_step`
converts ``(x, v)`` to planes once per call and back once at the end.
``K`` rollouts of one grid travel as ``(K, 3, W·H·D)`` planes (λ as
``(K, 5, cells)``) and take one launch per iteration, the rollout a
dimension of the launch grid, as JAX's planner ``vmap``s the grid over
its samples.

The TPU kernel runs a whole step in one pass a row block; its counterpart
here is the multi-substep mode (:func:`tet_fused_cuda`,
``tet_substep_kernel<1>``, ``make_tet_step``'s default
``fuse_substeps=True``): one cooperative launch a step, as many blocks as
the card holds at once, each taking (box, rollout) items in grid stride
and the grid synchronising after each of the ``substeps × max_iterations``
passes. A pass runs the per-iteration launch's code, so the two modes
agree bit for bit. Its scratch planes are allocated once per step
function (:class:`FusedScratch`). A card without cooperative launch, or a
launch that fails, raises; nothing falls back to the per-iteration mode.

Beside the kernel sits its plain PyTorch version,
:func:`tet_substep_reference`, composed of the ported integration
functions and :meth:`GridTetBatch.project`. The CPU tests run it, and the
card's smoke run holds the kernel against it. The step function that
:func:`make_tet_step` returns takes the plain version for CPU tensors
only; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .. import _build
from .._device import resolve_device
from ..ops import integration
from .grid_cloth_cuda import RESOURCE_KEYS
from .grid_tet import GridTetBatch

Tensor = torch.Tensor

N_PARAMS = 112                  # floats in the kernel's TetParams struct


def unsupported_reason(batch: GridTetBatch) -> Optional[str]:
    """Why the kernel cannot run this batch, or None when it can: the TPU
    kernel's preconditions (``grid_tet_pallas.py:57-62``)."""
    if batch.offset != 0:
        return "the tet kernel expects the tet grid at particle offset 0"
    if batch.inversion_handling:
        return ("the tet kernel does not implement the SVD inversion path; "
                "inversion_handling=True runs the stencil path")
    return None


def kernel_params(batch: GridTetBatch, *, h: float,
                  gravity=(0.0, -9.81, 0.0), damping: float = 0.0
                  ) -> np.ndarray:
    """The kernel's host-side scalars as ``N_PARAMS`` float32 values, in
    the layout of ``struct TetParams`` in ``csrc/grid_tet_step.cu``, each
    computed in float32 in the order the plain version computes it
    (``GridTetBatch._solve_family``). Raises NotImplementedError for a
    batch the kernel cannot run."""
    reason = unsupported_reason(batch)
    if reason is not None:
        raise NotImplementedError(reason)
    f32 = np.float32
    h32 = f32(h)
    p = np.zeros((N_PARAMS,), f32)
    # [parity 0 = even, 1 = odd][family][3x3 row-major], then volumes
    irm = [batch.inv_rest_even, batch.inv_rest_odd]
    vol = [batch.rest_vol_even, batch.rest_vol_odd]
    p[0:90] = np.concatenate([m.detach().cpu().numpy().astype(f32).ravel()
                              for m in irm])
    p[90:100] = np.concatenate([v.detach().cpu().numpy().astype(f32)
                                for v in vol])
    nu = f32(batch.poisson.item())
    e = f32(batch.youngs.item())
    mu = f32(0.5) / (f32(1.0) + nu)
    lame = nu / ((f32(1.0) + nu) * (f32(1.0) - f32(2.0) * nu))
    p[100] = mu
    p[101] = lame
    p[102] = f32(2.0) * mu
    p[103] = f32(0.5) * lame
    eh2 = e * h32 * h32
    p[104] = f32(1.0) / eh2 if abs(eh2) > f32(1e-30) else f32(0.0)
    p[105] = 1.0 if e > 0 else 0.0
    p[106] = h32
    p[107:110] = np.asarray(gravity, f32)
    p[110] = f32(1.0 - damping)
    p[111] = 1.0 if damping else 0.0
    return p


def to_planes(a: Tensor) -> Tensor:
    """``(N, 3)`` → contiguous component planes ``(3, N)``; ``(..., N,
    3)`` with rollout axes → ``(K, 3, N)``, ``K`` their product."""
    if a.dim() == 2:
        return a.t().contiguous()
    return a.reshape(-1, *a.shape[-2:]).transpose(-1, -2).contiguous()


def from_planes(p: Tensor, lead=None) -> Tensor:
    """Component planes ``(3, N)`` → ``(N, 3)``; ``(K, 3, N)`` →
    ``lead + (N, 3)`` (``lead`` the rollout axes, default ``(K,)``)."""
    if p.dim() == 2:
        return p.t()
    out = p.transpose(-1, -2)
    return out if lead is None else out.reshape(*lead, *out.shape[-2:])


def _bind(lib):
    fn = lib.pbd_tet_substep
    if getattr(fn, "_pbd_bound", False):
        return fn
    vp, ci = ctypes.c_void_p, ctypes.c_int
    # x_in, v_in, x_cur, w, inv_cnt, lam_in, lam_out, x_out, v_out, params,
    # W, H, D, stream
    fn.argtypes = [vp] * 10 + [ci, ci, ci, vp]
    fn.restype = ci
    if hasattr(lib, "pbd_tet_substep_batched"):
        # (absent from a source older than the rollout axis, which the
        # scripts' --source may load)
        # ... params, n_batch, w_bstride, W, H, D, stream
        lib.pbd_tet_substep_batched.argtypes = [vp] * 10 + [ci] * 5 + [vp]
        lib.pbd_tet_substep_batched.restype = ci
    lib.pbd_tet_error_string.argtypes = [ci]
    lib.pbd_tet_error_string.restype = ctypes.c_char_p
    lib.pbd_tet_param_count.argtypes = []
    lib.pbd_tet_param_count.restype = ci
    lib.pbd_tet_kernel_resources.argtypes = [vp]
    lib.pbd_tet_kernel_resources.restype = ci
    if hasattr(lib, "pbd_tet_step_fused"):
        # x_in, v_in, w, inv_cnt, x_out, v_out, xs, vs, x0, lam0, lam1,
        # params, n_batch, w_bstride, substeps, iterations, W, H, D,
        # grid_size, stream
        lib.pbd_tet_step_fused.argtypes = [vp] * 12 + [ci] * 7 + [vp, vp]
        lib.pbd_tet_step_fused.restype = ci
        lib.pbd_tet_fused_resources.argtypes = [vp]
        lib.pbd_tet_fused_resources.restype = ci
    if lib.pbd_tet_param_count() != N_PARAMS:
        raise RuntimeError("grid_tet_step.cu and grid_tet_cuda.py disagree "
                           "on the kernel's parameter layout")
    fn._pbd_bound = True
    return fn


def kernel_resources(lib=None, fused: bool = False) -> dict:
    """The kernel's resources as the CUDA runtime reports them on the
    current card: ``{"registers", "static_shared_bytes",
    "dynamic_shared_bytes", "local_bytes", "blocks_per_sm", "threads"}``,
    of the package's kernel or of ``lib``, a library built from a variant
    of ``csrc/grid_tet_step.cu``; of the multi-substep instance with
    ``fused``."""
    if lib is None:
        lib = _build.load("grid_tet_step")
    _bind(lib)
    vals = (ctypes.c_int * len(RESOURCE_KEYS))()
    err = (lib.pbd_tet_fused_resources if fused
           else lib.pbd_tet_kernel_resources)(vals)
    _check(lib, err, "tet kernel resources")
    return dict(zip(RESOURCE_KEYS, vals))


def _ptr(t: Optional[Tensor]):
    return None if t is None else t.data_ptr()


def lambda_plan(max_iterations: int):
    """Which of two λ planes each launch of a substep reads and writes:
    ``[(read, write)] * max_iterations``, None for no plane. The first
    launch reads none (λ starts at 0), the last writes none, and each
    launch reads the plane the one before it wrote and writes the other,
    since a block re-solves halo cells whose λ another block reads."""
    plan, last = [], None
    for it in range(max_iterations):
        write = None if it == max_iterations - 1 else it % 2
        plan.append((last, write))
        last = write
    return plan


def _check_planes(xp: Tensor, vp: Tensor, w: Tensor, ic: Tensor,
                  params: np.ndarray, dims, max_iterations: int, what: str):
    """Refuse what the kernel does not take. Returns ``(W, H, D)``, the
    rollouts ``K`` (1 for ``(3, N)`` planes), ``w``'s rollout stride and
    ``params`` as contiguous float32."""
    if xp.device.type != "cuda":
        raise ValueError(f"{what} takes CUDA tensors; the plain version is "
                         "tet_substep_reference")
    wd, hd, dd = (int(s) for s in dims)
    if min(wd, hd, dd) < 2:
        raise ValueError(f"grid {dims}: each side needs 2 vertices or more")
    n = wd * hd * dd
    k = 1 if xp.dim() == 2 else xp.shape[0]
    lead = () if xp.dim() == 2 else (k,)
    w_shapes = ((n,),) if xp.dim() == 2 else ((n,), (k, n))
    for name, t, shapes in (("x", xp, (lead + (3, n),)),
                            ("v", vp, (lead + (3, n),)),
                            ("w", w, w_shapes), ("inv_cnt", ic, ((n,),))):
        if t.device != xp.device or t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 on {xp.device}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) not in shapes or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous "
                             f"{' or '.join(map(str, shapes))}, got "
                             f"{tuple(t.shape)}")
    params = np.ascontiguousarray(params, np.float32)
    if params.shape != (N_PARAMS,):
        raise ValueError(f"params: expected ({N_PARAMS},), got {params.shape}")
    if max_iterations < 1:
        raise ValueError(f"max_iterations={max_iterations}: at least 1")
    return (wd, hd, dd), k, (n if w.dim() == 2 else 0), params


def tet_substep_cuda(xp: Tensor, vp: Tensor, w: Tensor, ic: Tensor,
                     params: np.ndarray, dims, max_iterations: int = 1):
    """Run one substep through the kernel, one launch per iteration.
    ``xp``, ``vp``: ``(3, N)`` float32 planes on one CUDA device, or ``(K,
    3, N)`` for ``K`` rollouts, ``N = W·H·D`` for ``dims = (W, H, D)``;
    ``w``: inverse masses ``(N,)`` shared by the rollouts, or ``(K, N)``;
    ``ic``: per-vertex Jacobi weights ``(N,)``; ``params`` from
    :func:`kernel_params`. Returns new ``(xp, vp)`` buffers; the inputs
    are left as they were. Counts its launches in
    ``tet_substep_cuda.launches``."""
    (wd, hd, dd), k, w_bstride, params = _check_planes(
        xp, vp, w, ic, params, dims, max_iterations, "tet_substep_cuda")
    lib = _build.load("grid_tet_step")
    _bind(lib)
    fn = lib.pbd_tet_substep_batched
    lead = () if xp.dim() == 2 else (k,)
    n_cells = (wd - 1) * (hd - 1) * (dd - 1)
    plan = lambda_plan(max_iterations)
    x_cur = vo = None
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        lam = [xp.new_empty(lead + (5, n_cells))
               for _ in range(min(2, max_iterations - 1))]
        for it, (read, write) in enumerate(plan):
            xo = torch.empty_like(xp)
            if it == max_iterations - 1:
                vo = torch.empty_like(vp)
            err = fn(xp.data_ptr(), vp.data_ptr(), _ptr(x_cur),
                     w.data_ptr(), ic.data_ptr(),
                     None if read is None else lam[read].data_ptr(),
                     None if write is None else lam[write].data_ptr(),
                     xo.data_ptr(), _ptr(vo), params.ctypes.data, k,
                     w_bstride, wd, hd, dd, stream)
            _check(lib, err, "tet kernel launch failed")
            tet_substep_cuda.launches += 1
            x_cur = xo
    return x_cur, vo


tet_substep_cuda.launches = 0


def _check(lib, err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: " + lib.pbd_tet_error_string(err).decode())


class FusedScratch:
    """The multi-substep launch's scratch planes, allocated at the first
    launch of a shape and kept for every later one: positions and
    velocities like the state's planes, a substep's start positions past
    one iteration, and two λ planes ``(K, 5, cells)`` past one (the
    second past two). The launch leaves them undefined, so one scratch
    serves launches in turn on one stream."""

    def __init__(self):
        self._key = None
        self.bufs = None

    def get(self, xp: Tensor, n_cells: int, substeps: int,
            iterations: int):
        """``(xs, vs, x0, lam0, lam1)`` for planes like ``xp``, None where
        the launch needs no such buffer."""
        key = (xp.device, tuple(xp.shape), n_cells, substeps, iterations)
        if key != self._key:
            lead = tuple(xp.shape[:-2])
            self.bufs = (
                xp.new_empty(xp.shape) if substeps * iterations > 1 else None,
                xp.new_empty(xp.shape) if substeps > 1 else None,
                xp.new_empty(xp.shape) if iterations > 1 else None,
                xp.new_empty(lead + (5, n_cells)) if iterations > 1 else None,
                xp.new_empty(lead + (5, n_cells)) if iterations > 2 else None)
            self._key = key
        return self.bufs


def tet_fused_cuda(xp: Tensor, vp: Tensor, w: Tensor, ic: Tensor,
                   params: np.ndarray, dims, max_iterations: int = 1,
                   substeps: int = 1, scratch: Optional[FusedScratch] = None):
    """Run one solver step, ``substeps`` substeps of ``max_iterations``
    iterations, through the multi-substep kernel in one cooperative
    launch — the counterpart of one ``pallas_call`` of
    ``make_pallas_tet_step``. Arguments as :func:`tet_substep_cuda`;
    ``scratch`` keeps the launch's scratch planes between calls (a fresh
    one when None). Returns new ``(xp, vp)`` buffers and leaves the inputs
    as they were. Raises where the card has no cooperative launch or the
    launch fails. Counts its launches in ``tet_fused_cuda.launches`` and
    keeps the last launch's grid size in ``tet_fused_cuda.grid``."""
    (wd, hd, dd), k, w_bstride, params = _check_planes(
        xp, vp, w, ic, params, dims, max_iterations, "tet_fused_cuda")
    if substeps < 1:
        raise ValueError(f"substeps={substeps}: at least 1")
    lib = _build.load("grid_tet_step")
    _bind(lib)
    n_cells = (wd - 1) * (hd - 1) * (dd - 1)
    grid = ctypes.c_int(0)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        bufs = (scratch or FusedScratch()).get(xp, n_cells, substeps,
                                               max_iterations)
        xo, vo = torch.empty_like(xp), torch.empty_like(vp)
        err = lib.pbd_tet_step_fused(
            xp.data_ptr(), vp.data_ptr(), w.data_ptr(), ic.data_ptr(),
            xo.data_ptr(), vo.data_ptr(), *(_ptr(b) for b in bufs),
            params.ctypes.data, k, w_bstride, substeps, max_iterations, wd,
            hd, dd, ctypes.byref(grid), stream)
        _check(lib, err, "tet multi-substep launch failed")
    tet_fused_cuda.launches += 1
    tet_fused_cuda.grid = grid.value
    return xo, vo


tet_fused_cuda.launches = 0
tet_fused_cuda.grid = None


def run_substeps(xp: Tensor, vp: Tensor, w: Tensor, ic: Tensor,
                 params: np.ndarray, dims, max_iterations: int, n: int):
    """``n`` substeps through :func:`tet_substep_cuda`. Returns the final
    ``(xp, vp)`` planes and the inputs of the last and of the second-last
    substep (``old_x`` and ``last_x`` of the stepper), None where there
    was no such substep."""
    old = last = None
    for _ in range(n):
        last, old = old, xp
        xp, vp = tet_substep_cuda(xp, vp, w, ic, params, dims,
                                  max_iterations)
    return xp, vp, old, last


def tet_substep_reference(batch: GridTetBatch, x: Tensor, v: Tensor,
                          inv_mass: Tensor, *, h: float,
                          max_iterations: int = 1,
                          gravity=(0.0, -9.81, 0.0), damping: float = 0.0):
    """The kernel's plain PyTorch version: one substep of ``_substep`` for
    a scene that is this tet grid alone, Jacobi with ``omega = 1``, λ
    carried across the iterations. ``x``, ``v``: ``(N, 3)``; returns
    ``(x, v)``."""
    g = torch.as_tensor(gravity, dtype=torch.float32, device=x.device)
    xn, vn = integration.semi_implicit_euler(h, inv_mass, x, v,
                                             g.expand_as(x))
    lam = batch.init_lambda()
    for _ in range(max_iterations):
        xn, lam = batch.project(xn, inv_mass, lam, h)
    vn = integration.velocity_update_first_order(h, inv_mass, xn, x, vn)
    if damping:
        vn = vn * (1.0 - damping)
    return xn, vn


def make_tet_step(batch: GridTetBatch, inv_mass, *, dt: float, substeps: int,
                  max_iterations: int = 1, gravity=(0.0, -9.81, 0.0),
                  damping: float = 0.0, n_steps: int = 1,
                  fuse_substeps: bool = True, device=None):
    """Build ``step(x (N, 3), v (N, 3)) -> (x, v)`` that advances
    ``n_steps`` steps of ``substeps`` substeps of a scene that is this tet
    grid alone, covering particles ``[0, W·H·D)`` — the counterpart of
    ``make_pallas_tet_step``. Raises NotImplementedError for a batch the
    kernel cannot run (offset ≠ 0, ``inversion_handling``), as the TPU
    kernel does, in either mode.

    On ``device`` (None means CUDA) the step launches the kernel: with
    ``fuse_substeps`` (the default, as the TPU kernel always fuses) one
    cooperative launch a step (:func:`tet_fused_cuda`, ``n_steps``
    launches a call, as JAX scans its ``pallas_call``), else one launch
    per iteration of each substep. Given CPU tensors either mode runs
    :func:`tet_substep_reference`."""
    dev = resolve_device(device)
    dims = (batch.width, batch.height, batch.depth)
    n = batch.width * batch.height * batch.depth
    h = dt / substeps
    params = kernel_params(batch, h=h, gravity=gravity, damping=damping)
    if max_iterations < 1:
        raise ValueError(f"max_iterations={max_iterations}: at least 1")
    if batch.device != dev:
        batch = batch.to(dev)
    w = torch.as_tensor(inv_mass, dtype=torch.float32, device=dev)
    if w.numel() != n:
        raise ValueError(f"inv_mass: {w.numel()} values for a "
                         f"{'x'.join(map(str, dims))} tet grid")
    w = w.reshape(n).contiguous()
    ic = batch.inv_cnt.reshape(n).contiguous()
    n_sub = n_steps * substeps
    scratch = FusedScratch()

    def step(x: Tensor, v: Tensor):
        if tuple(x.shape) != (n, 3) or tuple(v.shape) != (n, 3):
            raise ValueError(f"expected x, v of shape {(n, 3)}, got "
                             f"{tuple(x.shape)} and {tuple(v.shape)}")
        if x.device != dev or v.device != dev:
            raise ValueError(f"step was built for {dev}; got tensors on "
                             f"{x.device} and {v.device}")
        if dev.type == "cuda":
            xp, vp = to_planes(x), to_planes(v)
            if fuse_substeps:
                for _ in range(n_steps):
                    xp, vp = tet_fused_cuda(xp, vp, w, ic, params, dims,
                                            max_iterations, substeps,
                                            scratch)
            else:
                xp, vp, _, _ = run_substeps(xp, vp, w, ic, params, dims,
                                            max_iterations, n_sub)
            return from_planes(xp), from_planes(vp)
        for _ in range(n_sub):
            x, v = tet_substep_reference(
                batch, x, v, w, h=h, max_iterations=max_iterations,
                gravity=gravity, damping=damping)
        return x, v

    return step
