"""The cell-dense PBF passes as hand-written CUDA kernels for Hopper — the
counterpart of ``positionbaseddynamics_tpu/fluids/cellgrid_pallas.py``.

Three kernels in ``csrc/pbf_cells.cu``, one warp per active cell:

* ``density_lambda_cuda`` (B3, ``_density_lambda_kernel``): density with
  the boundary ψ terms, then λ, written into the ``(n_cells, cap)`` λ and
  density tables at the active rows;
* ``corrections_cuda`` (B4, ``_corr_kernel``): the position corrections,
  read with the neighbors' λ from the λ table, written as the new
  positions of the active rows into a separate table;
* ``xsph_cuda`` (B5, ``_xsph_kernel``): the XSPH velocity smoothing,
  written as the new velocities of the active rows into a separate table.

All three are bound by their fp32 operations on the H100 (the candidate
pair tests and the kernel arithmetic of the pairs in range). B3 and B4
copy each cell's 27-cell neighbourhood into the warp's shared memory with
``cp.async`` (:func:`stage_capacity` fluid and boundary candidates at a
time, in chunks past that), one warp and one cell a
block, and share the 32 lanes among the cell's particles, a power-of-two
group of lanes each: a lane tests its candidates into a bit mask, then
walks the pairs that passed, and a shuffle tree adds the group's partial
sums in a fixed order. B5 keeps one lane per slot walking the neighbour
rows in global memory. Every pass recomputes the step's frozen pair set
from the pre-projection table ``xt0`` with explicitly rounded
operations, so its pairs equal the plain version's. Each wrapper checks
device, dtype, shape and contiguity and raises on anything the kernel
does not take; it counts its launches in ``<wrapper>.launches``. There
is no fallback: :func:`pbf_step_cuda` takes CUDA tensors only.
:func:`kernel_resources` reports each kernel's registers, shared memory,
spills and resident blocks an SM.

Their plain PyTorch versions are :func:`cellgrid.density_lambda_reference`,
:func:`cellgrid.corrections_reference` and :func:`cellgrid.xsph_reference`
(imported here beside the kernels), from which ``cellgrid.pbf_iterations``
and ``cellgrid.xsph_cell`` are composed.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from . import sph
from .cellgrid import (corrections_reference,  # noqa: F401 (plain versions)
                       density_lambda_reference, occupied_count,
                       xsph_reference)

Tensor = torch.Tensor

N_PARAMS = 8                    # floats in the kernel's PbfParams struct
KERNELS = ("pbf_density_lambda", "pbf_corrections", "pbf_xsph")


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def kernel_params(density0, support, viscosity=0.0) -> np.ndarray:
    """The kernels' scalars as ``N_PARAMS`` float32 values in the layout of
    ``struct PbfParams`` in ``csrc/pbf_cells.cu``, each rounded from the
    double the plain version rounds: h, h², ρ₀, k = 8/(πh³) (= W(0)), 2k,
    l = 48/(πh³), −l, −ν."""
    h = float(support)
    k = 8.0 / (sph._PI * h**3)
    l = 48.0 / (sph._PI * h**3)
    return np.array([h, h * h, float(density0), k, k * 2.0, l, -l,
                     -float(viscosity)], np.float32)


def _bind(lib):
    fns = (lib.pbd_pbf_density_lambda, lib.pbd_pbf_corrections,
           lib.pbd_pbf_xsph)
    if getattr(fns[0], "_pbd_bound", False):
        return fns
    vp, ci = ctypes.c_void_p, ctypes.c_int
    # the cells struct's pointers: x, x0, m, count, active, nbr, nbr_ok,
    # bx, bpsi, bcount; then n_cells, cap, capb, K
    cells = [vp] * 10 + [ci] * 4
    # cells..., lam_t, dens_t, params, stream
    fns[0].argtypes = cells + [vp, vp, vp, vp]
    # cells..., lam_t, x_out, params, stream
    fns[1].argtypes = cells + [vp, vp, vp, vp]
    # cells..., vt, dens_t, v_out, params, stream
    fns[2].argtypes = cells + [vp, vp, vp, vp, vp]
    for fn in fns:
        fn.restype = ci
    lib.pbd_pbf_error_string.argtypes = [ci]
    lib.pbd_pbf_error_string.restype = ctypes.c_char_p
    lib.pbd_pbf_param_count.argtypes = []
    lib.pbd_pbf_param_count.restype = ci
    lib.pbd_pbf_stage_capacity.argtypes = [vp]
    lib.pbd_pbf_stage_capacity.restype = None
    lib.pbd_pbf_kernel_resources.argtypes = [ci, vp]
    lib.pbd_pbf_kernel_resources.restype = ci
    if lib.pbd_pbf_param_count() != N_PARAMS:
        raise RuntimeError("pbf_cells.cu and cellgrid_cuda.py disagree on "
                           "the kernels' parameter layout")
    fns[0]._pbd_bound = True
    return fns


def stage_capacity() -> tuple:
    """``(fluid, boundary)``: the candidates a warp of B3 and B4 stages in
    shared memory at a time, as ``csrc/pbf_cells.cu`` defines them; a
    longer neighbourhood is walked in chunks."""
    lib = _build.load("pbf_cells")
    _bind(lib)
    out = (ctypes.c_int * 2)()
    lib.pbd_pbf_stage_capacity(out)
    return tuple(out)


def kernel_resources() -> dict:
    """Each kernel's resources as the CUDA runtime reports them on the
    current card: ``{name: {"registers", "shared_bytes", "local_bytes",
    "blocks_per_sm"}}``, the last at each launch's block size (one warp
    for B3 and B4, four for B5)."""
    lib = _build.load("pbf_cells")
    _bind(lib)
    out = {}
    for which, name in enumerate(KERNELS):
        vals = (ctypes.c_int * 4)()
        err = lib.pbd_pbf_kernel_resources(which, vals)
        if err != 0:
            raise RuntimeError(f"{name}: " + lib.pbd_pbf_error_string(
                err).decode())
        out[name] = dict(zip(("registers", "shared_bytes", "local_bytes",
                              "blocks_per_sm"), vals))
    return out


def _expect(name, t, shape, dtype, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype} on {device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {tuple(shape)}, got "
                         f"{tuple(t.shape)}"
                         + ("" if t.is_contiguous() else " (strided)"))


def _cells_args(spec, xt, xt0, mt, count, active, nbr, nbr_ok):
    """Check the inputs every kernel takes and return the C arguments of
    the kernels' cell struct."""
    dev = xt.device
    if dev.type != "cuda":
        raise ValueError("the PBF kernels take CUDA tensors; the plain "
                         "versions are the *_reference functions")
    nc, cap = spec.n_cells, spec.cap
    k = active.shape[0]
    f32, i32 = torch.float32, torch.int32
    _expect("xt", xt, (3, nc, cap), f32, dev)
    _expect("xt0", xt0, (3, nc, cap), f32, dev)
    _expect("mt", mt, (nc, cap), f32, dev)
    _expect("count", count, (nc,), i32, dev)
    _expect("active", active, (k,), i32, dev)
    _expect("nbr", nbr, (k, 27), i32, dev)
    _expect("nbr_ok", nbr_ok, (k, 27), torch.bool, dev)
    if 3 * nc * cap >= 2**31 or k > spec.n_cells:
        raise ValueError(f"{nc} cells of {cap} slots, {k} active: beyond "
                         "the kernels' int32 indexing")
    bt = spec.boundary
    if bt is None:
        b = [None, None, None, 0]
    else:
        _expect("boundary.xt", bt.xt, (3, nc, bt.capb), f32, dev)
        _expect("boundary.psit", bt.psit, (nc, bt.capb), f32, dev)
        _expect("boundary.count", bt.count, (nc,), i32, dev)
        b = [bt.xt.data_ptr(), bt.psit.data_ptr(), bt.count.data_ptr(),
             bt.capb]
    return [xt.data_ptr(), xt0.data_ptr(), mt.data_ptr(), count.data_ptr(),
            active.data_ptr(), nbr.data_ptr(), nbr_ok.data_ptr(),
            b[0], b[1], b[2], nc, cap, b[3], k]


def _launch(which, fn, lib, args, device):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"PBF {which} kernel launch failed: "
                           + lib.pbd_pbf_error_string(err).decode())


def density_lambda_cuda(spec, xt, xt0, mt, count, active, nbr, nbr_ok,
                        lam_t, dens_t, params):
    """B3: write λ and density of every slot of the active cells into the
    ``(n_cells, cap)`` tables ``lam_t`` and ``dens_t`` (other rows are left
    as they are). ``count``: :func:`cellgrid.occupied_count` of ``mt``;
    ``params``: :func:`kernel_params`. Counts its launches in
    ``density_lambda_cuda.launches``."""
    args = _cells_args(spec, xt, xt0, mt, count, active, nbr, nbr_ok)
    for name, t in (("lam_t", lam_t), ("dens_t", dens_t)):
        _expect(name, t, mt.shape, torch.float32, xt.device)
    if active.shape[0] == 0:
        return
    lib = _build.load("pbf_cells")
    fn = _bind(lib)[0]
    _launch("density/lambda", fn, lib, args + [
        lam_t.data_ptr(), dens_t.data_ptr(), _params_ptr(params)],
        xt.device)
    density_lambda_cuda.launches += 1


density_lambda_cuda.launches = 0


def corrections_cuda(spec, xt, xt0, mt, count, lam_t, active, nbr, nbr_ok,
                     x_out, params):
    """B4: write ``x + Δx`` of every slot of the active cells into
    ``x_out`` (a table other than ``xt``; other rows are left as they are),
    with λ read from ``lam_t``. Counts its launches in
    ``corrections_cuda.launches``."""
    args = _cells_args(spec, xt, xt0, mt, count, active, nbr, nbr_ok)
    _expect("lam_t", lam_t, mt.shape, torch.float32, xt.device)
    _expect("x_out", x_out, xt.shape, torch.float32, xt.device)
    if x_out.data_ptr() in (xt.data_ptr(), xt0.data_ptr()):
        raise ValueError("x_out must not be an input: neighbors read the "
                         "positions it replaces")
    if active.shape[0] == 0:
        return
    lib = _build.load("pbf_cells")
    fn = _bind(lib)[1]
    _launch("corrections", fn, lib, args + [
        lam_t.data_ptr(), x_out.data_ptr(), _params_ptr(params)],
        xt.device)
    corrections_cuda.launches += 1


corrections_cuda.launches = 0


def xsph_cuda(spec, xt, xt0, vt, mt, count, dens_t, active, nbr, nbr_ok,
              v_out, params):
    """B5: write ``v − ν·dv`` of every slot of the active cells into
    ``v_out`` (a table other than ``vt``; other rows are left as they
    are), with ρ read from ``dens_t``. Counts its launches in
    ``xsph_cuda.launches``."""
    args = _cells_args(spec, xt, xt0, mt, count, active, nbr, nbr_ok)
    _expect("vt", vt, xt.shape, torch.float32, xt.device)
    _expect("dens_t", dens_t, mt.shape, torch.float32, xt.device)
    _expect("v_out", v_out, xt.shape, torch.float32, xt.device)
    if v_out.data_ptr() == vt.data_ptr():
        raise ValueError("v_out must not be vt: neighbors read the "
                         "velocities it replaces")
    if active.shape[0] == 0:
        return
    lib = _build.load("pbf_cells")
    fn = _bind(lib)[2]
    _launch("XSPH", fn, lib, args + [
        vt.data_ptr(), dens_t.data_ptr(), v_out.data_ptr(),
        _params_ptr(params)], xt.device)
    xsph_cuda.launches += 1


xsph_cuda.launches = 0


def _params_ptr(params: np.ndarray) -> int:
    if params.dtype != np.float32 or params.shape != (N_PARAMS,) \
            or not params.flags.c_contiguous:
        raise ValueError(f"params: expected ({N_PARAMS},) float32 from "
                         "kernel_params")
    return params.ctypes.data


def pbf_step_cuda(spec, xt, mt, active, nbr, nbr_ok, n_iter, density0,
                  support, vt=None, viscosity=0.0, density=None, xt0=None):
    """``n_iter`` density-projection iterations (B3 then B4 each) and,
    when ``vt`` is given, one XSPH pass (B5), through the kernels. Same
    semantics as ``cellgrid.pbf_iterations`` + ``xsph_cell``; returns
    ``(xt, density (n_cells, cap), vt_or_None)``.

    ``xt0`` is the step's pre-projection table, which freezes the pair set
    of every pass, XSPH included; it defaults to ``xt``. ``n_iter = 0``
    with ``vt`` and the last iteration's ``density`` runs only B5. The
    λ and density tables are zeroed once per call and B3 rewrites their
    active rows each iteration; B4 writes into two tables copied from
    ``xt`` in turn, so the rows of cells outside ``active`` carry through.
    The inputs are left as they were."""
    if xt0 is None:
        xt0 = xt
    count = occupied_count(mt)
    params = kernel_params(density0, support, viscosity)
    if n_iter > 0:
        lam_t = torch.zeros_like(mt)
        density = torch.zeros_like(mt)
        bufs = [xt.clone(), xt.clone() if n_iter > 1 else None]
        cur = xt
        for it in range(n_iter):
            density_lambda_cuda(spec, cur, xt0, mt, count, active, nbr,
                                nbr_ok, lam_t, density, params)
            out = bufs[it % 2]
            corrections_cuda(spec, cur, xt0, mt, count, lam_t, active, nbr,
                             nbr_ok, out, params)
            cur = out
        xt = cur
    elif density is None:
        density = torch.zeros_like(mt)
    vt_out = None
    if vt is not None:
        vt_out = vt.clone()
        xsph_cuda(spec, xt, xt0, vt, mt, count, density, active, nbr,
                  nbr_ok, vt_out, params)
    return xt, density, vt_out
