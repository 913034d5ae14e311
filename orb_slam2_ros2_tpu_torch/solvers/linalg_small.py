"""Tiny fixed-size linear algebra, unrolled (port of
``orb_slam2_ros2_tpu/solvers/linalg_small.py``).

Closed-form or unrolled versions of the 6×6 SPD solve, the 3×3 inverse and
the rotation↔quaternion maps, and a fixed-sweep one-sided Jacobi SVD with the
minimum-norm least squares built on it: plain elementwise ops that batch over
leading dimensions and never synchronise with the host (``torch.linalg``
solvers may check for errors on the host; on the H100 ``eigh``, ``svd`` and
``pinv`` synchronise and refuse a CUDA-graph capture).
"""

from __future__ import annotations

import torch


def cholesky_solve_spd(A: torch.Tensor, b: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Solve A x = b for SPD A [..., n, n] with b [..., n], n static & small.

    Unrolled Cholesky without pivoting (valid for damped SPD normal
    matrices), then forward/backward substitution.
    """
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=eps))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def inv3(A: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Closed-form (adjugate) inverse of [..., 3, 3] matrices."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = torch.where(det.abs() > eps, det, torch.where(det >= 0, eps, -eps))
    inv = torch.stack(
        [
            torch.stack([A11, A12, A13], -1),
            torch.stack([A21, A22, A23], -1),
            torch.stack([A31, A32, A33], -1),
        ],
        dim=-2,
    )
    return inv / det[..., None, None]


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] → quaternion [..., 4] (w, x, y, z), branch-free: the four
    candidate extractions, the largest pivot selected with ``where``."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    s0 = safe_sqrt(tr + 1.0) * 2
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], -1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], -1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], -1)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], -1)

    use0 = (tr > 0.0)[..., None]
    use1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    use2 = (m11 >= m22)[..., None]
    q = torch.where(use0, q0, torch.where(use1, q1, torch.where(use2, q2, q3)))
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def _jacobi_round(X: torch.Tensor, m: int) -> torch.Tensor:
    """One round of one-sided (Hestenes) Jacobi on ``X`` [..., m + n, n], the
    matrix's rows over the accumulated rotation's: columns j and j + n/2 are
    rotated so that their first ``m`` rows become orthogonal, then the
    columns move one seat along the round-robin circle (column 0 stays), so
    that n − 1 rounds pair every two columns once."""
    h = X.shape[-1] // 2
    P, Q = X[..., :h], X[..., h:]
    norms = torch.sum(X[..., :m, :] * X[..., :m, :], dim=-2)
    alpha, beta = norms[..., :h], norms[..., h:]
    gamma = torch.sum(P[..., :m, :] * Q[..., :m, :], dim=-2)
    zero = gamma == 0.0
    zeta = (beta - alpha) / (2.0 * torch.where(zero, 1.0, gamma))
    t = torch.where(zeta >= 0, 1.0, -1.0) / (zeta.abs() + torch.sqrt(1.0 + zeta * zeta))
    t = torch.where(zero, 0.0, t)
    c = torch.rsqrt(1.0 + t * t)[..., None, :]
    s = c * t[..., None, :]
    P2, Q2 = c * P - s * Q, s * P + c * Q
    if h == 1:
        return torch.cat([P2, Q2], dim=-1)
    return torch.cat([P2[..., :1], Q2[..., :1], P2[..., 1:h - 1], Q2[..., 1:], P2[..., h - 1:]], dim=-1)


def jacobi_svd(A: torch.Tensor, sweeps: int = 6):
    """SVD of [..., m, n] by one-sided Jacobi with a fixed number of sweeps
    (n − 1 rounds each, n rounded up to even by a zero column): the columns
    of A·V are made orthogonal by plane rotations accumulated in V, so the
    small singular values keep their relative accuracy (no AᵀA is formed).
    Returns (s [..., n] descending, V [..., n, n] whose columns are the
    right singular vectors in that order, W = A·V [..., m, n], the columns
    s_j·u_j).  Every singular vector's sign is arbitrary, as LAPACK's."""
    m, n = A.shape[-2:]
    ne = n + n % 2
    eye = torch.eye(ne, dtype=A.dtype, device=A.device).expand(*A.shape[:-2], ne, ne)
    if ne > n:
        A = torch.cat([A, torch.zeros_like(A[..., :1])], dim=-1)
    X = torch.cat([A, eye], dim=-2)
    for _ in range(sweeps * (ne - 1)):
        X = _jacobi_round(X, m)
    W, V = X[..., :m, :], X[..., m:, :]
    s = torch.sqrt(torch.sum(W * W, dim=-2))
    # the padding column is the one whose V row n holds its 1: it sorts last
    key = s if ne == n else torch.where(V[..., n, :] > 0.5, -1.0, s)
    order = torch.sort(key, dim=-1, descending=True, stable=True).indices[..., :n]
    V = torch.gather(V[..., :n, :], -1, order[..., None, :].expand(*V.shape[:-2], n, n))
    W = torch.gather(W, -1, order[..., None, :].expand(*W.shape[:-2], m, n))
    return torch.gather(s, -1, order), V, W


def lstsq_min_norm(A: torch.Tensor, b: torch.Tensor, rcond: float, sweeps: int = 6) -> torch.Tensor:
    """Minimum-norm least squares ``argmin ‖A x − b‖`` for A [..., m, n] and
    b [..., m]: ``pinv(A, rtol=rcond) @ b`` through ``jacobi_svd``, the
    singular values at or below ``rcond``·s_max dropped."""
    s, V, W = jacobi_svd(A, sweeps)
    keep = s > rcond * s[..., :1]
    coef = torch.einsum("...mn,...m->...n", W, b) / torch.where(keep, s * s, 1.0)
    return torch.einsum("...ij,...j->...i", V, torch.where(keep, coef, 0.0))
