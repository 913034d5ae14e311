"""Batched two-view triangulation (port of
``orb_slam2_ros2_tpu/geometry/triangulate.py``; reference
src/LocalMapping.cc:311-339 ``triangulate``).

The DLT system of every candidate match is solved at once through its 3×3
normal equations with a closed-form adjugate inverse; the reference's
σ₃/σ₂ null-space gate becomes a conditioning gate on the closed-form
(Cardano) eigenvalues of the normal matrix.  Plain elementwise ops: no
batched SVD, no host synchronisation.
"""

from __future__ import annotations

import math

import torch

from . import se3
from .camera import CameraParams


def dlt_rows(cam: CameraParams, Tcw: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Two DLT rows ``x·P3 − P1`` and ``y·P3 − P2`` for one view, with P =
    [R|t] and (x, y) the normalized coords: [..., 2, 4]."""
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    P = Tcw[..., :3, :]
    r0 = x[..., None] * P[..., 2, :] - P[..., 0, :]
    r1 = y[..., None] * P[..., 2, :] - P[..., 1, :]
    return torch.stack([r0, r1], dim=-2)


def _sym3_eigenvalues(M: torch.Tensor):
    """Closed-form (Cardano) eigenvalues of symmetric [..., 3, 3] matrices,
    ascending."""
    q = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1) / 3.0
    Mq = M - q[..., None, None] * torch.eye(3, dtype=M.dtype, device=M.device)
    p2 = torch.sum(Mq * Mq, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    B = Mq / p[..., None, None]
    detB = (B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 1])
            - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 0])
            + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1] - B[..., 1, 1] * B[..., 2, 0]))
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    l1 = q + 2.0 * p * torch.cos(phi)                         # largest
    l3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)   # smallest
    l2 = 3.0 * q - l1 - l3
    return l3, l2, l1


def triangulate_pairs(
    cam: CameraParams,
    Tcw1: torch.Tensor,   # [..., 4, 4] world→cam1
    uv1: torch.Tensor,    # [..., 2]
    Tcw2: torch.Tensor,
    uv2: torch.Tensor,
    rank_gate: float = 1e-3,
):
    """DLT-triangulate matched observations.  Returns (points_w [..., 3],
    ok [...]): ``A[:, :3] X = −A[:, 3]`` solved through the normal
    equations, rejected when λ_min/λ_max of AᵀA falls under ``rank_gate²``
    or the determinant vanishes."""
    A = torch.cat([dlt_rows(cam, Tcw1, uv1), dlt_rows(cam, Tcw2, uv2)], dim=-2)
    A3 = A[..., :3]
    b = -A[..., 3]
    M = torch.einsum("...ki,...kj->...ij", A3, A3)
    rhs = torch.einsum("...ki,...k->...i", A3, b)

    m00, m01, m02 = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    m11, m12, m22 = M[..., 1, 1], M[..., 1, 2], M[..., 2, 2]
    c00 = m11 * m22 - m12 * m12
    c01 = m02 * m12 - m01 * m22
    c02 = m01 * m12 - m02 * m11
    c11 = m00 * m22 - m02 * m02
    c12 = m01 * m02 - m00 * m12
    c22 = m00 * m11 - m01 * m01
    det = m00 * c00 + m01 * c01 + m02 * c02
    adj = torch.stack([
        torch.stack([c00, c01, c02], dim=-1),
        torch.stack([c01, c11, c12], dim=-1),
        torch.stack([c02, c12, c22], dim=-1),
    ], dim=-2)
    ok_det = det.abs() > 1e-20
    pw = torch.einsum("...ij,...j->...i", adj, rhs) / torch.where(ok_det, det, 1.0)[..., None]

    l_min, _, l_max = _sym3_eigenvalues(M)
    ok_rank = l_min > (rank_gate * rank_gate) * torch.clamp(l_max, min=1e-20)
    return pw, ok_rank & ok_det


def parallax_cos(Tcw1: torch.Tensor, uv1_norm: torch.Tensor, Tcw2: torch.Tensor,
                 uv2_norm: torch.Tensor) -> torch.Tensor:
    """Cosine of the ray parallax between two views for normalized image
    coords [..., 2] (reference LocalMapping.cc:231-259); smaller = larger
    parallax."""
    r1 = torch.cat([uv1_norm, torch.ones_like(uv1_norm[..., :1])], dim=-1)
    r2 = torch.cat([uv2_norm, torch.ones_like(uv2_norm[..., :1])], dim=-1)
    d1 = torch.einsum("...ij,...j->...i", se3.R_of(Tcw1).transpose(-1, -2), r1)
    d2 = torch.einsum("...ij,...j->...i", se3.R_of(Tcw2).transpose(-1, -2), r2)
    num = torch.sum(d1 * d2, dim=-1)
    den = torch.linalg.vector_norm(d1, dim=-1) * torch.linalg.vector_norm(d2, dim=-1)
    return num / torch.clamp(den, min=1e-12)


def depth_in_view(Tcw: torch.Tensor, pw: torch.Tensor) -> torch.Tensor:
    """z of world points in a camera (positive-depth checks,
    LocalMapping.cc:265-271)."""
    return se3.apply(Tcw, pw)[..., 2]
