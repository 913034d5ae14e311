"""Closed-form point-set alignment (Horn's quaternion method), batched.

Port of ``orb_slam2_ros2_tpu/geometry/align.py`` (reference:
src/Sim3Solver.cc:50-148 — the 4×4 N matrix and its maximal eigenvector,
the asymmetric scale s = D/Sp and the fixed-scale mode for stereo,
Sim3Solver.h:71-76).  Used by the Sim3 RANSAC and by EPnP's control-point
alignment.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..solvers.linalg_small import quat_to_rot  # (w, x, y, z) → R, shared with se3.normalize


def _max_eigvec_4x4(N: torch.Tensor, squarings: int = 9) -> torch.Tensor:
    """Maximal eigenvector of symmetric [..., 4, 4] matrices by shifted
    matrix squaring (no iterative eigensolver, no host synchronisation).

    Shift by the Frobenius norm so B = N + cI is PSD with the same
    eigenvector order, then square B ``squarings`` times, normalizing to the
    largest entry: B^(2⁹) amplifies the top eigenvalue by ratio^512.  The
    top eigenvector is then any dominant column; two seed applications and a
    norm pick guard a seed that is orthogonal to it.  An exactly degenerate
    top pair returns some vector of the top eigenspace — every consumer
    scores or refines the result."""
    c = torch.linalg.matrix_norm(N)                        # ‖N‖_F ≥ |λ_min|
    B = N + (c[..., None, None] + 1e-9) * torch.eye(4, dtype=N.dtype, device=N.device)
    for _ in range(squarings):
        B = B @ B
        B = B / torch.clamp(B.abs().amax(dim=(-2, -1), keepdim=True), min=1e-30)
    ones = torch.ones(N.shape[:-1], dtype=N.dtype, device=N.device)
    alt = torch.stack([ones[..., 0], -ones[..., 1], ones[..., 2], -ones[..., 3]], dim=-1)
    v1 = torch.einsum("...ij,...j->...i", B, ones)
    v2 = torch.einsum("...ij,...j->...i", B, alt)
    n1 = torch.linalg.vector_norm(v1, dim=-1, keepdim=True)
    n2 = torch.linalg.vector_norm(v2, dim=-1, keepdim=True)
    v = torch.where(n1 >= n2, v1, v2)
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-30)


def horn_align(
    src: torch.Tensor,      # [..., S, 3]
    dst: torch.Tensor,      # [..., S, 3]
    weights: torch.Tensor,  # [..., S] (0 masks a pair)
    with_scale: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Find (R, t, s) minimizing Σ w‖dst − (s·R·src + t)‖²: R from the
    maximal eigenvector of the 4×4 N matrix built from the correlation
    M = Σ w·src̃·dst̃ᵀ, the scale by the asymmetric D/Sp form
    (Sim3Solver.cc:135-148)."""
    wsum = torch.clamp(weights.sum(dim=-1, keepdim=True), min=1e-9)
    wn = weights / wsum
    mu_s = torch.sum(src * wn[..., None], dim=-2, keepdim=True)
    mu_d = torch.sum(dst * wn[..., None], dim=-2, keepdim=True)
    xs = (src - mu_s) * torch.sqrt(wn)[..., None]
    xd = (dst - mu_d) * torch.sqrt(wn)[..., None]
    M = torch.einsum("...si,...sj->...ij", xs, xd)

    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack(
        [
            torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
            torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
            torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
            torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
        ],
        dim=-2,
    )
    R = quat_to_rot(_max_eigvec_4x4(N))  # maximal eigenvector as (w, x, y, z)

    if with_scale:
        rot_s = torch.einsum("...ij,...sj->...si", R, xs)
        num = torch.sum(xd * rot_s, dim=(-1, -2))
        den = torch.clamp(torch.sum(xs * xs, dim=(-1, -2)), min=1e-12)
        s = num / den
    else:
        s = torch.ones(M.shape[:-2], dtype=M.dtype, device=M.device)

    t = mu_d[..., 0, :] - s[..., None] * torch.einsum("...ij,...j->...i", R, mu_s[..., 0, :])
    return R, t, s
