"""Feature-major ("planar") bundle-adjustment edge terms (port of
``orb_slam2_ros2_tpu/solvers/edge_fm.py``).

Every per-edge quantity is a stack of scalar planes with the component axis
leading and the edge axes trailing (``r [3, *E]``, ``Jc [18, *E]`` with
(residual k, se3 param j) → 6k+j, ``Jp [9, *E]`` with (k, j) → 3k+j), so no
tensor has a tiny trailing ``3×6`` block and every contraction over the
component axes unrolls to elementwise ops.  The math is the reference's g2o
stereo/mono reprojection edge (src/Optimizer.cc:86-160).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.camera import CameraParams


class EdgeTerms(NamedTuple):
    r: torch.Tensor     # f32[3, *E]
    Jc: torch.Tensor    # f32[18, *E]  (6k+j)
    Jp: torch.Tensor    # f32[9, *E]   (3k+j)
    dim: torch.Tensor   # f32[3, *E]   residual-dimension mask (1, 1, is_stereo)
    chi2: torch.Tensor  # f32[*E]


def _project(cam, R9, t3, pw3):
    px, py, pz = pw3[0], pw3[1], pw3[2]
    x = R9[0] * px + R9[1] * py + R9[2] * pz + t3[0]
    y = R9[3] * px + R9[4] * py + R9[5] * pz + t3[1]
    z = R9[6] * px + R9[7] * py + R9[8] * pz + t3[2]
    z = torch.where(z > 1e-6, z, 1e-6)
    return x, y, z


def edge_terms(
    cam: CameraParams,
    R9: torch.Tensor,        # f32[9, *E] per-edge camera rotation (row-major)
    t3: torch.Tensor,        # f32[3, *E]
    pw3: torch.Tensor,       # f32[3, *E] per-edge world point
    uv2: torch.Tensor,       # f32[2, *E] measured pixel
    right_u: torch.Tensor,   # f32[*E] measured right u (−1 = mono)
    inv_sigma2: torch.Tensor,  # f32[*E]
) -> EdgeTerms:
    """Residuals + analytic Jacobians for a batch of reprojection edges."""
    x, y, z = _project(cam, R9, t3, pw3)
    inv_z = 1.0 / z
    inv_z2 = inv_z * inv_z
    u = cam.fx * x * inv_z + cam.cx
    v = cam.fy * y * inv_z + cam.cy
    ur = u - cam.bf * inv_z
    is_stereo = right_u > 0

    r0 = u - uv2[0]
    r1 = v - uv2[1]
    r2 = torch.where(is_stereo, ur - right_u, 0.0)
    one = torch.ones_like(r0)
    st = is_stereo.to(r0.dtype)
    dim = torch.stack([one, one, st])

    # ∂pix/∂pc rows (du, dv, dur)
    zero = torch.zeros_like(z)
    du = (cam.fx * inv_z, zero, -cam.fx * x * inv_z2)
    dv = (zero, cam.fy * inv_z, -cam.fy * y * inv_z2)
    dur = (du[0], du[1], du[2] + cam.bf * inv_z2)
    dpix = (du, dv, dur)

    # Jc[k, 0:3] = dpix[k];  Jc[k, 3:6] = dpix[k] · (−hat(pc))
    Jc_rows = []
    for k in range(3):
        a0, a1, a2 = dpix[k]
        Jc_rows += [
            a0, a1, a2,
            a1 * (-z) + a2 * y,
            a0 * z + a2 * (-x),
            a0 * (-y) + a1 * x,
        ]
    Jc = torch.stack(Jc_rows)

    # Jp[k, j] = Σ_a dpix[k][a] · R[a, j]
    Jp_rows = []
    for k in range(3):
        a0, a1, a2 = dpix[k]
        for j in range(3):
            Jp_rows.append(a0 * R9[j] + a1 * R9[3 + j] + a2 * R9[6 + j])
    Jp = torch.stack(Jp_rows)

    r = torch.stack([r0, r1, r2])
    chi2 = (r0 * r0 + r1 * r1 + r2 * r2 * st) * inv_sigma2
    return EdgeTerms(r=r, Jc=Jc, Jp=Jp, dim=dim, chi2=chi2)


def edge_chi2(
    cam: CameraParams,
    R9: torch.Tensor, t3: torch.Tensor, pw3: torch.Tensor,
    uv2: torch.Tensor, right_u: torch.Tensor, inv_sigma2: torch.Tensor,
) -> torch.Tensor:
    """χ² only (no Jacobians): ``edge_terms(...).chi2`` at a fraction of
    the work."""
    x, y, z = _project(cam, R9, t3, pw3)
    inv_z = 1.0 / z
    u = cam.fx * x * inv_z + cam.cx
    v = cam.fy * y * inv_z + cam.cy
    ur = u - cam.bf * inv_z
    r0 = u - uv2[0]
    r1 = v - uv2[1]
    r2 = torch.where(right_u > 0, ur - right_u, 0.0)
    return (r0 * r0 + r1 * r1 + r2 * r2) * inv_sigma2


# symmetric-matrix component index maps
SYM3 = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
SYM3_AT = {
    (0, 0): 0, (0, 1): 1, (1, 0): 1, (0, 2): 2, (2, 0): 2,
    (1, 1): 3, (1, 2): 4, (2, 1): 4, (2, 2): 5,
}
# (a, b≥a) row-major component index of a symmetric 6×6
SYM6_AT = {}
_k = 0
for _a in range(6):
    for _b in range(_a, 6):
        SYM6_AT[(_a, _b)] = SYM6_AT[(_b, _a)] = _k
        _k += 1


def _weighted(terms: EdgeTerms, w: torch.Tensor):
    return [w * terms.dim[k] for k in range(3)]


def _reduce(s: torch.Tensor, reduce_axis):
    return torch.sum(s, dim=reduce_axis) if reduce_axis is not None else s


def hpp_comps(terms: EdgeTerms, w: torch.Tensor, reduce_axis: int) -> torch.Tensor:
    """Σ_edges Jpᵀ W Jp as 6 symmetric components [6, ...]."""
    wm = _weighted(terms, w)
    outs = []
    for a, b in SYM3:
        s = 0.0
        for k in range(3):
            s = s + wm[k] * terms.Jp[3 * k + a] * terms.Jp[3 * k + b]
        outs.append(torch.sum(s, dim=reduce_axis))
    return torch.stack(outs)


def bp_comps(terms: EdgeTerms, w: torch.Tensor, reduce_axis: int) -> torch.Tensor:
    """Σ_edges Jpᵀ W r as [3, ...]."""
    wm = _weighted(terms, w)
    outs = []
    for a in range(3):
        s = 0.0
        for k in range(3):
            s = s + wm[k] * terms.Jp[3 * k + a] * terms.r[k]
        outs.append(torch.sum(s, dim=reduce_axis))
    return torch.stack(outs)


def hcc_comps(terms: EdgeTerms, w: torch.Tensor, reduce_axis=None) -> torch.Tensor:
    """Jcᵀ W Jc as 21 symmetric components [21, ...]; reduced over
    ``reduce_axis`` when given, else per edge."""
    wm = _weighted(terms, w)
    outs = []
    for a in range(6):
        for b in range(a, 6):
            s = 0.0
            for k in range(3):
                s = s + wm[k] * terms.Jc[6 * k + a] * terms.Jc[6 * k + b]
            outs.append(_reduce(s, reduce_axis))
    return torch.stack(outs)


def bc_comps(terms: EdgeTerms, w: torch.Tensor, reduce_axis=None) -> torch.Tensor:
    """Jcᵀ W r as [6, ...]; reduced over ``reduce_axis`` when given."""
    wm = _weighted(terms, w)
    outs = []
    for a in range(6):
        s = 0.0
        for k in range(3):
            s = s + wm[k] * terms.Jc[6 * k + a] * terms.r[k]
        outs.append(_reduce(s, reduce_axis))
    return torch.stack(outs)


def g_comps(terms: EdgeTerms, w: torch.Tensor) -> torch.Tensor:
    """Per-edge coupling G = Jcᵀ W Jp as [18, *E] ((a, b) → 3a+b)."""
    wm = _weighted(terms, w)
    outs = []
    for a in range(6):
        for b in range(3):
            s = 0.0
            for k in range(3):
                s = s + wm[k] * terms.Jc[6 * k + a] * terms.Jp[3 * k + b]
            outs.append(s)
    return torch.stack(outs)


def sym3_inv(c: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Closed-form inverse of symmetric 3×3 components [6, ...]
    ((00, 01, 02, 11, 12, 22)), same layout out."""
    a, b, cc, d, e, f = c[0], c[1], c[2], c[3], c[4], c[5]
    A = d * f - e * e
    B = cc * e - b * f
    C = b * e - cc * d
    D = a * f - cc * cc
    E = b * cc - a * e
    F = a * d - b * b
    det = a * A + b * B + cc * C
    det = torch.where(det.abs() > eps, det, torch.where(det >= 0, eps, -eps))
    return torch.stack([A, B, C, D, E, F]) * (1.0 / det)


def sym3_apply(c: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Symmetric 3×3 (components [6, ...]) times vector [3, ...]."""
    return torch.stack([
        c[0] * v[0] + c[1] * v[1] + c[2] * v[2],
        c[1] * v[0] + c[3] * v[1] + c[4] * v[2],
        c[2] * v[0] + c[4] * v[1] + c[5] * v[2],
    ])


def sym6_apply(c: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Symmetric 6×6 (21 components [21, ...]) times vector [6, ...]."""
    outs = []
    for a in range(6):
        s = 0.0
        for b in range(6):
            s = s + c[SYM6_AT[(a, b)]] * v[b]
        outs.append(s)
    return torch.stack(outs)


def sym6_to_dense(c: torch.Tensor) -> torch.Tensor:
    """[21, K] symmetric components → [K, 6, 6] dense."""
    M = torch.stack([torch.stack([c[SYM6_AT[(a, b)]] for b in range(6)]) for a in range(6)])
    return torch.movedim(M, -1, 0)


def gT_apply(G: torch.Tensor, x6: torch.Tensor) -> torch.Tensor:
    """Per-edge Gᵀ x: G [18, *E], x6 [6, *E] → [3, *E]."""
    outs = []
    for b in range(3):
        s = 0.0
        for a in range(6):
            s = s + G[3 * a + b] * x6[a]
        outs.append(s)
    return torch.stack(outs)


def g_apply(G: torch.Tensor, z3: torch.Tensor) -> torch.Tensor:
    """Per-edge G z: G [18, *E], z3 [3, *E] → [6, *E]."""
    outs = []
    for a in range(6):
        s = 0.0
        for b in range(3):
            s = s + G[3 * a + b] * z3[b]
        outs.append(s)
    return torch.stack(outs)
