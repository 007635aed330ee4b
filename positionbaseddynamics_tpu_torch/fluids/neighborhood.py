"""Fixed-radius neighbor search by sort-based spatial hashing — the
counterpart of ``positionbaseddynamics_tpu/fluids/neighborhood.py``.

The reference's ``NeighborhoodSearchSpatialHashing`` hash map becomes a
sort: every particle's cell is hashed with the reference's XOR of primes,
the hashes are sorted (stably, so the candidate lists equal the JAX
package's), and each of the 27 neighbor cells is found with
``searchsorted``. Candidates come back as a fixed ``(N, 27·cap)`` index
array and a validity mask. Hash collisions between distinct cells are
resolved exactly by comparing integer cell coordinates; ``cell_overflow``
counts the particles a per-cell cap crowds out. Nothing here syncs the
host."""
from __future__ import annotations

import functools

import torch

Tensor = torch.Tensor

# the reference's hash primes (NeighborhoodSearchSpatialHashing.h:12-19)
_P1, _P2, _P3 = 73856093, 19349663, 83492791


@functools.lru_cache(maxsize=16)
def _primes(device):
    return torch.tensor([_P1, _P2, _P3], dtype=torch.int32, device=device)


def _cell_hash(cell: Tensor) -> Tensor:
    """XOR-of-primes cell hash on int32 cell coords ``(..., 3)``; the
    products wrap in int32 as they do in JAX."""
    m = cell * _primes(cell.device)
    return m[..., 0] ^ m[..., 1] ^ m[..., 2]


def _cells(x: Tensor, radius) -> Tensor:
    inv = torch.full((), 1.0 / radius, dtype=torch.float32, device=x.device)
    return torch.floor(x * inv).to(torch.int32)


def neighbor_candidates(x: Tensor, radius, cap_per_cell: int = 12):
    """Candidate neighbor indices within the 27 cells around each point.

    ``x``: ``(N, 3)`` positions; ``radius``: search radius = cell size;
    ``cap_per_cell``: static per-cell candidate cap. Returns ``(idx (N,
    27·cap) int64, valid (N, 27·cap) bool)``; ``valid`` includes the
    ``‖xᵢ−xⱼ‖ < radius`` test and excludes self."""
    n = x.shape[0]
    dev = x.device
    cell = _cells(x, radius)
    h = _cell_hash(cell)
    order = torch.argsort(h, stable=True)
    h_sorted = h[order]

    r = torch.arange(-1, 2, dtype=torch.int32, device=dev)
    offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                       -1).reshape(27, 3)
    ncell = cell[:, None, :] + offs[None, :, :]
    nh = _cell_hash(ncell)                       # (N, 27)

    start = torch.searchsorted(h_sorted, nh)     # (N, 27)
    take = torch.arange(cap_per_cell, device=dev)
    pos = start[..., None] + take                # (N, 27, cap)
    pos_c = torch.clamp_max(pos, n - 1)
    same_hash = h_sorted[pos_c] == nh[..., None]
    in_range = pos < n
    idx_3d = order[pos_c]                        # (N, 27, cap)
    # exact cell check: mirror-image offsets collide systematically
    same_cell = same_hash
    for c in range(3):
        same_cell = same_cell & (cell[:, c][idx_3d]
                                 == ncell[..., c][..., None])
    idx = idx_3d.reshape(n, -1)                  # (N, 27*cap)
    valid = (same_cell & in_range).reshape(n, -1)

    dist2 = sum((x[:, c][idx] - x[:, c][:, None]) ** 2 for c in range(3))
    valid = valid & (dist2 < radius * radius)
    valid = valid & (idx != torch.arange(n, device=dev)[:, None])
    return idx, valid


def cell_overflow(x: Tensor, radius, cap_per_cell: int = 12) -> Tensor:
    """Number of particles crowded out by the static ``cap_per_cell``
    limit: ``Σ_cells max(0, occupancy − cap)``, a 0-d int64 tensor. Zero
    means the capacity was enough this step."""
    h_sorted = torch.sort(_cell_hash(_cells(x, radius))).values
    first = torch.searchsorted(h_sorted, h_sorted, side="left")
    last = torch.searchsorted(h_sorted, h_sorted, side="right")
    occupancy = last - first
    is_first = torch.arange(h_sorted.shape[0], device=x.device) == first
    over = torch.clamp_min(occupancy - cap_per_cell, 0)
    return torch.sum(torch.where(is_first, over, torch.zeros_like(over)))
