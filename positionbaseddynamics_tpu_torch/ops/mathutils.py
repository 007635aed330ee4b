"""Small dense-math helpers shared by the constraint solvers.

Port of ``positionbaseddynamics_tpu/ops/mathutils.py`` except
``extract_rotation``, which needs the quaternion ops of the rigid-body
slice (6a): the degeneracy threshold, the guarded reciprocal, the
cotangent, the unrolled 3×3 products, determinant and inverse, the
signed SVD with inversion handling in both of its forms (LAPACK on the
CPU, the scalar Jacobi eigendecomposition on CUDA, chosen by the tensor's
device as JAX chooses by its backend), and the polar decompositions.

Vectors are ``(..., 3)`` and matrices ``(..., 3, 3)`` tensors; every
function broadcasts over the leading axes where the JAX function is
``vmap``-ed.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

#: Generic degeneracy threshold of the reference kernels (``XPBD.cpp:8``).
EPS = 1e-6


def safe_inv(x: Tensor, eps: float = 1e-30) -> Tensor:
    """``1/x`` where ``|x| > eps``, else 0 (``mathutils.py:20-23``)."""
    big = torch.abs(x) > eps
    return torch.where(big, 1.0 / torch.where(big, x, torch.ones_like(x)),
                       torch.zeros_like(x))


def sqrt_rn(a: Tensor) -> Tensor:
    """Correctly rounded float32 square root. PyTorch's vectorised CPU
    ``sqrt`` can miss by an ulp; float64 holds enough bits that rounding
    its root to float32 gives the correctly rounded float32 root."""
    if a.device.type == "cpu" and a.dtype == torch.float32:
        return torch.sqrt(a.double()).float()
    return torch.sqrt(a)


def dot3(a: Tensor, b: Tensor) -> Tensor:
    """``a · b`` over the trailing axis of 3, added left to right."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) \
        + a[..., 2] * b[..., 2]


def cross3(a: Tensor, b: Tensor) -> Tensor:
    """``a × b`` over the trailing axis of 3, as ``jnp.cross``."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def norm3(a: Tensor) -> Tensor:
    """Euclidean norm over the trailing axis of 3."""
    return sqrt_rn(dot3(a, a))


def cot_theta(v: Tensor, w: Tensor) -> Tensor:
    """``cot θ = (v·w)/‖v×w‖``, guarded against parallel vectors
    (``mathutils.py:26-32``)."""
    return dot3(v, w) * safe_inv(torch.clamp_min(norm3(cross3(v, w)),
                                                 1e-12))


def _sum3(terms):
    """``t0 + t1 + t2`` left to right, as the JAX package's Python ``sum``
    adds them."""
    a, b, c = terms
    return (a + b) + c


def mm3(a: Tensor, b: Tensor) -> Tensor:
    """``a @ b`` for 3×3 matrices as unrolled multiply-adds."""
    return torch.stack([torch.stack(
        [_sum3([a[..., i, k] * b[..., k, j] for k in range(3)])
         for j in range(3)], dim=-1) for i in range(3)], dim=-2)


def mm3_tn(a: Tensor, b: Tensor) -> Tensor:
    """``aᵀ @ b`` unrolled (see :func:`mm3`)."""
    return torch.stack([torch.stack(
        [_sum3([a[..., k, i] * b[..., k, j] for k in range(3)])
         for j in range(3)], dim=-1) for i in range(3)], dim=-2)


def mm3_nt(a: Tensor, b: Tensor) -> Tensor:
    """``a @ bᵀ`` unrolled (see :func:`mm3`)."""
    return torch.stack([torch.stack(
        [_sum3([a[..., i, k] * b[..., j, k] for k in range(3)])
         for j in range(3)], dim=-1) for i in range(3)], dim=-2)


def mv3(a: Tensor, x: Tensor) -> Tensor:
    """``a @ x`` for a 3-vector, unrolled (see :func:`mm3`)."""
    return torch.stack([_sum3([a[..., i, k] * x[..., k] for k in range(3)])
                        for i in range(3)], dim=-1)


def det3(a: Tensor) -> Tensor:
    """Explicit 3×3 determinant by cofactors of the first row."""
    return (a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2]
                            - a[..., 1, 2] * a[..., 2, 1])
            - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2]
                              - a[..., 1, 2] * a[..., 2, 0])
            + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1]
                              - a[..., 1, 1] * a[..., 2, 0]))


def inv3(a: Tensor, eps: float = 1e-30) -> Tensor:
    """Adjugate 3×3 inverse (``mathutils.py:117-138``); a singular input
    gives large but finite values, which the caller masks."""
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    det = (a[..., 0, 0] * c00 + a[..., 0, 1] * c01) + a[..., 0, 2] * c02
    inv_det = 1.0 / torch.where(torch.abs(det) > eps, det,
                                torch.full_like(det, eps))
    rows = [[c00, c10, c20], [c01, c11, c21], [c02, c12, c22]]
    return torch.stack([torch.stack([rows[i][j] * inv_det for j in range(3)],
                                    dim=-1) for i in range(3)], dim=-2)


def cross_product_matrix(v: Tensor) -> Tensor:
    """Skew-symmetric ``[v]×`` with ``[v]× u = v × u``
    (``mathutils.py:334-340``)."""
    zero = torch.zeros_like(v[..., 0])
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def _jacobi_eigh_3x3(m: Tensor, sweeps: int = 6):
    """Eigendecomposition of symmetric 3×3 matrices by cyclic Jacobi
    rotations in unrolled scalar arithmetic (``mathutils.py:35-80``).
    Returns ``(eigvals (..., 3), V (..., 3, 3))`` with ``m = V diag(λ)
    Vᵀ``."""
    a = {(0, 0): m[..., 0, 0], (1, 1): m[..., 1, 1], (2, 2): m[..., 2, 2],
         (0, 1): m[..., 0, 1], (0, 2): m[..., 0, 2], (1, 2): m[..., 1, 2]}
    one, zero = torch.ones_like(a[(0, 0)]), torch.zeros_like(a[(0, 0)])
    v = {(i, j): one if i == j else zero for i in range(3) for j in range(3)}

    def key(i, j):
        return (i, j) if (i, j) in a else (j, i)

    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            r = 3 - p - q                     # the untouched index
            app, aqq, apq = a[(p, p)], a[(q, q)], a[key(p, q)]
            theta = 0.5 * torch.atan2(2.0 * apq, app - aqq)
            c = torch.cos(theta)
            s = torch.sin(theta)
            cc, ss, cs = c * c, s * s, c * s
            apr, aqr = a[key(p, r)], a[key(q, r)]
            a[(p, p)] = (cc * app + 2.0 * cs * apq) + ss * aqq
            a[(q, q)] = (ss * app - 2.0 * cs * apq) + cc * aqq
            a[key(p, q)] = cs * (aqq - app) + (cc - ss) * apq
            a[key(p, r)] = c * apr + s * aqr
            a[key(q, r)] = -s * apr + c * aqr
            for i in range(3):
                vip, viq = v[(i, p)], v[(i, q)]
                v[(i, p)] = c * vip + s * viq
                v[(i, q)] = -s * vip + c * viq

    eig = torch.stack([a[(0, 0)], a[(1, 1)], a[(2, 2)]], dim=-1)
    vm = torch.stack([torch.stack([v[(i, j)] for j in range(3)], dim=-1)
                      for i in range(3)], dim=-2)
    return eig, vm


def svd_inversion_handling(a: Tensor):
    """Signed SVD ``A = U diag(σ) Vᵀ`` with ``U, V ∈ SO(3)``: a reflection
    in U or V becomes a rotation by negating its third column (row of Vᵀ)
    and the smallest singular value with it — the semantics of
    ``MathFunctions::svdWithInversionHandling``. As the JAX package
    chooses by its backend (``mathutils.py:158-174``), a CUDA tensor takes
    the scalar Jacobi form and a CPU tensor the LAPACK form; both agree to
    float32 precision. Returns ``(U, sigma, VT)``."""
    if a.device.type == "cuda":
        return _svd_inversion_handling_jacobi(a)
    return _svd_inversion_handling_lapack(a)


def _svd_inversion_handling_lapack(a: Tensor):
    """The LAPACK form (``mathutils.py:177-187``)."""
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    one = torch.ones((), dtype=a.dtype, device=a.device)
    su = torch.where(torch.linalg.det(u) < 0.0, -one, one)
    sv = torch.where(torch.linalg.det(vt) < 0.0, -one, one)
    u = torch.cat([u[..., :2], u[..., 2:] * su[..., None, None]], dim=-1)
    vt = torch.cat([vt[..., :2, :], vt[..., 2:, :] * sv[..., None, None]],
                   dim=-2)
    s = torch.cat([s[..., :2], s[..., 2:] * (su * sv)[..., None]], dim=-1)
    return u, s, vt


def _where_vec(cond: Tensor, a: Tensor, b: Tensor) -> Tensor:
    return torch.where(cond[..., None], a, b)


def _svd_inversion_handling_jacobi(a: Tensor):
    """The Jacobi-eigendecomposition form (``mathutils.py:190-231``): V
    from ``AᵀA`` sorted by descending eigenvalue and made a rotation, U's
    first two columns from ``A·vᵢ`` (Gram-Schmidt corrected, with fixed
    fallbacks for degenerate A), the third their cross product, and the
    sign of ``det A`` folded into σ₂."""
    lam, v = _jacobi_eigh_3x3(mm3_tn(a, a))
    cols = [v[..., :, 0], v[..., :, 1], v[..., :, 2]]
    lams = [lam[..., 0], lam[..., 1], lam[..., 2]]
    for i, j in ((0, 1), (0, 2), (1, 2)):
        swap = lams[i] < lams[j]
        lams[i], lams[j] = (torch.where(swap, lams[j], lams[i]),
                            torch.where(swap, lams[i], lams[j]))
        cols[i], cols[j] = (_where_vec(swap, cols[j], cols[i]),
                            _where_vec(swap, cols[i], cols[j]))
    one = torch.ones((), dtype=a.dtype, device=a.device)
    cols[2] = cols[2] * torch.where(
        det3(torch.stack(cols, dim=-1)) < 0.0, -one, one)[..., None]
    v = torch.stack(cols, dim=-1)
    sig = sqrt_rn(torch.clamp_min(torch.stack(lams, dim=-1), 0.0))

    # the unit axes made on the device (a host tensor copied to the card
    # would make the host wait for the stream)
    ex, ey, ez = torch.eye(3, dtype=a.dtype, device=a.device)
    av0 = mv3(a, cols[0])
    av1 = mv3(a, cols[1])
    n0 = norm3(av0)[..., None]
    u0 = torch.where(n0 > 1e-12, av0 / torch.clamp_min(n0, 1e-30), ex)
    av1 = av1 - dot3(av1, u0)[..., None] * u0
    n1 = norm3(av1)[..., None]
    fallback1 = cross3(u0, ez)
    fallback2 = cross3(u0, ey)
    fb = torch.where(norm3(fallback1)[..., None] > 0.1, fallback1,
                     fallback2)
    fb = fb / torch.clamp_min(norm3(fb), 1e-30)[..., None]
    u1 = torch.where(n1 > 1e-12, av1 / torch.clamp_min(n1, 1e-30), fb)
    u = torch.stack([u0, u1, cross3(u0, u1)], dim=-1)      # det(U) = +1
    s2 = sig[..., 2] * torch.where(det3(a) < 0.0, -one, one)
    sig = torch.cat([sig[..., :2], s2[..., None]], dim=-1)
    return u, sig, v.transpose(-1, -2)


def _one_norm(a: Tensor) -> Tensor:
    """Largest column sum of |a| (``mathutils.py:247``)."""
    return torch.abs(a).sum(dim=-2).amax(dim=-1)


def _inf_norm(a: Tensor) -> Tensor:
    """Largest row sum of |a|."""
    return torch.abs(a).sum(dim=-1).amax(dim=-1)


def _adjt(mt: Tensor) -> Tensor:
    return torch.stack([cross3(mt[..., 1, :], mt[..., 2, :]),
                        cross3(mt[..., 2, :], mt[..., 0, :]),
                        cross3(mt[..., 0, :], mt[..., 1, :])], dim=-2)


def polar_decomposition_stable(m: Tensor, tolerance: float = 1e-6,
                               max_iter: int = 36) -> Tensor:
    """Rotation factor ``R`` of the polar decomposition by the
    reference's scaled Newton iteration
    (``MathFunctions::polarDecompositionStable``, ``mathutils.py:234-290``)
    with its stopping rule ``E₁ ≤ tol·‖Mt‖₁``: a fixed ``max_iter`` passes
    in which each matrix freezes at its own convergence, so the loop never
    asks the device whether it is done. A degenerate input (every cross
    product of its rows vanishes) gives the identity."""
    mt0 = m.transpose(-1, -2)
    mt, mone, minf = mt0, _one_norm(m), _inf_norm(m)
    done = torch.zeros(m.shape[:-2], dtype=torch.bool, device=m.device)
    for _ in range(max_iter):
        madjtt = _adjt(mt)
        det = (mt[..., 0, 0] * madjtt[..., 0, 0]
               + mt[..., 0, 1] * madjtt[..., 0, 1]) \
            + mt[..., 0, 2] * madjtt[..., 0, 2]
        degenerate = torch.abs(det) < 1e-12
        gamma = sqrt_rn(
            sqrt_rn((_one_norm(madjtt) * _inf_norm(madjtt))
                    / torch.clamp_min(mone * minf, 1e-30))
            / torch.clamp_min(torch.abs(det), 1e-30))
        g1 = gamma * 0.5
        g2 = 0.5 / (gamma * torch.where(degenerate, torch.ones_like(det),
                                        det))
        new_mt = g1[..., None, None] * mt + g2[..., None, None] * madjtt
        eone = _one_norm(mt - new_mt)
        new_mone, new_minf = _one_norm(new_mt), _inf_norm(new_mt)
        converged = (eone <= new_mone * tolerance) | degenerate
        mt = torch.where(done[..., None, None], mt, new_mt)
        mone = torch.where(done, mone, new_mone)
        minf = torch.where(done, minf, new_minf)
        done = done | converged
    bad = torch.abs(_adjt(mt0)).amax(dim=(-2, -1)) < 1e-12
    eye = torch.eye(3, dtype=m.dtype, device=m.device)
    return torch.where(bad[..., None, None], eye, mt.transpose(-1, -2))


def polar_decomposition(a: Tensor):
    """``A = R S`` with ``R ∈ SO(3)`` through the signed SVD
    (``mathutils.py:293-302``). Returns ``(R, S)``."""
    u, s, vt = svd_inversion_handling(a)
    return mm3(u, vt), mm3_tn(vt, s[..., :, None] * vt)
