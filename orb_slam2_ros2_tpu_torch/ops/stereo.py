"""Stereo keypoint matching: dense hamming coarse match + SAD refinement
(port of ``orb_slam2_ros2_tpu/ops/stereo.py``; reference:
src/ORBMatcher.cc:18-81 ``searchByStereo``, :841-905 ``pixelSADMatch``).

Gates kept from the reference: |v_L − v_R| ≤ 2·scale^octave_R, 0 < u_L − u_R
< fx, best distance ≤ 75, |octave_L − octave_R| ≤ 1, centre-subtracted SAD,
sub-pixel parabola only for an interior minimum with |δ| < 1.  Like the JAX
version it also requires a mutual left↔right best match and adds the full
SAD displacement.  Argmin ties resolve to the first index, as in JAX.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .hamming import hamming_matrix
from .patches import CENTER as PC


def extract_rect(canvas: torch.Tensor, centers_yx: torch.Tensor, half_y: int, half_x: int) -> torch.Tensor:
    """``[N, 2·half_y+1, 2·half_x+1]`` windows of ``canvas [H, W]`` around
    integer (y, x) centres ``[N, 2]``, with ``lax.dynamic_slice``'s index
    rules: a negative start counts from the far edge (start + dim), then
    every start is clamped into the canvas — a window is never padded."""
    sy, sx = 2 * half_y + 1, 2 * half_x + 1
    h, w = canvas.shape
    if sy > h or sx > w:
        raise ValueError(f"a {sy}x{sx} window does not fit a {h}x{w} canvas")

    def start(s, dim, size):
        return torch.where(s < 0, s + dim, s).clamp(0, dim - size)

    c = centers_yx.long()
    y0 = start(c[:, 0] - half_y, h, sy)
    x0 = start(c[:, 1] - half_x, w, sx)
    rows = y0[:, None, None] + torch.arange(sy, device=canvas.device)[None, :, None]
    cols = x0[:, None, None] + torch.arange(sx, device=canvas.device)[None, None, :]
    return canvas[rows, cols]


def level_coords(uv_raw: torch.Tensor, octave: torch.Tensor, scale_factor: float) -> torch.Tensor:
    """Level-0 pixel coords → the keypoint's own pyramid-level coords."""
    inv = torch.pow(1.0 / scale_factor, octave.float())
    return uv_raw * inv[..., None]


def canvas_centers(
    uv_raw: torch.Tensor, octave: torch.Tensor, scale_factor: float, row_offsets: torch.Tensor
) -> torch.Tensor:
    """Integer (y, x) canvas addresses (int32) of keypoints at their own level."""
    lc = level_coords(uv_raw, octave, scale_factor)
    y = torch.round(lc[..., 1]).to(torch.int32) + row_offsets[octave.long()]
    x = torch.round(lc[..., 0]).to(torch.int32)
    return torch.stack([y, x], dim=-1)


def stereo_match(
    featL,
    featR,
    patchesL: torch.Tensor,
    patchesR: torch.Tensor,
    *,
    scale_factor: float,
    fx: float,
    bf: float,
    image_width: int,
    mean_threshold: int = 75,
    sad_half: int = 5,
    search_half: int = 5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Match left→right keypoints, return (right_u [N], depth [N]); −1 = none.

    ``patchesL/R`` are the f32[N, 48, 64] keypoint patches the extractor
    already gathered; the SAD windows are static sub-slices of them.
    """
    uvL, uvR = featL.uv, featR.uv
    n = uvL.shape[0]
    dev = uvL.device

    dist = hamming_matrix(featL.desc, featR.desc)  # [N, M] int32

    scale_r = torch.pow(scale_factor, featR.octave.float())
    row_slack = 2.0 * scale_r
    dv = (uvL[:, None, 1] - uvR[None, :, 1]).abs()
    du = uvL[:, None, 0] - uvR[None, :, 0]
    cand = (
        featL.valid[:, None] & featR.valid[None, :]
        & (dv <= row_slack[None, :]) & (du > 0.0) & (du < fx)
    )
    BIG = 1 << 20
    masked = torch.where(cand, dist, BIG)
    best_j = torch.argmin(masked, dim=1)
    best_d = torch.gather(masked, 1, best_j[:, None])[:, 0]

    # left↔right mutual-best consistency
    best_i = torch.argmin(masked, dim=0)
    mutual = best_i[best_j] == torch.arange(n, device=dev)

    oct_r = featR.octave[best_j]
    ok = (
        (best_d <= mean_threshold)
        & ((featL.octave - oct_r).abs() <= 1)
        & (best_d < BIG)
        & mutual
    )

    # ---- SAD refinement on each keypoint's own pyramid level -----------------
    uvR_best = featR.uv_raw[best_j]
    w = sad_half
    patchL = patchesL[:, PC - w:PC + w + 1, PC - w:PC + w + 1]
    strip_all = patchesR[:, PC - w:PC + w + 1, PC - w - search_half:PC + w + search_half + 1]
    strip = strip_all[best_j]                                      # [N, 11, 21]
    patchL = patchL - patchL[:, w, w][:, None, None]

    n_shifts = 2 * search_half + 1
    wins = torch.stack([strip[:, :, s:s + 2 * w + 1] for s in range(n_shifts)], dim=1)
    centers = wins[:, :, w, w]                                     # [N, S]
    wins = wins - centers[:, :, None, None]
    scores = torch.sum((wins - patchL[:, None]).abs(), dim=(-1, -2))  # [N, S]

    best_l = torch.argmin(scores, dim=1)
    interior = (best_l > 0) & (best_l < n_shifts - 1)
    il = torch.clamp(best_l, 1, n_shifts - 2)
    s1 = torch.gather(scores, 1, il[:, None] - 1)[:, 0]
    s2 = torch.gather(scores, 1, il[:, None])[:, 0]
    s3 = torch.gather(scores, 1, il[:, None] + 1)[:, 0]
    denom = s1 + s3 - 2.0 * s2
    big_denom = denom.abs() > 1e-6
    delta = torch.where(big_denom, 0.5 * (s1 - s3) / torch.where(big_denom, denom, 1.0), 0.0)
    delta = torch.where(interior & (delta.abs() < 1.0), delta, 0.0)
    shift = torch.where(interior, best_l.float() - search_half + delta, 0.0)

    scale_best = torch.pow(scale_factor, oct_r.float())
    right_u = uvR_best[:, 0] + shift * scale_best
    right_u = torch.clamp(right_u, 0.0, float(image_width - 1))
    disparity = featL.uv[:, 0] - right_u
    # fall back to the unrefined coordinate when refinement crossed zero disparity
    right_u = torch.where(disparity <= 0.0, uvR_best[:, 0], right_u)
    disparity = featL.uv[:, 0] - right_u
    # sub-pixel disparities below ~0.5 px give unusably noisy depth
    ok = ok & (disparity > 0.5)

    depth = torch.where(ok, bf / torch.where(disparity > 0, disparity, 1.0), -1.0)
    right_u = torch.where(ok, right_u, -1.0)
    return right_u, depth
