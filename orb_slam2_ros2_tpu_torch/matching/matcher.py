"""Descriptor matching: dense, masked, batched (port of
``orb_slam2_ros2_tpu/matching/matcher.py``; reference src/ORBMatcher.cc
searchByProjection :265-347/:561-612, getBestMatch :967-990, verifyAngle
:1013-1051).

Every search is a full Q×T hamming matrix with a geometric candidate mask, a
masked argmin (first index on ties, as in JAX) and vectorised ratio /
rotation-histogram / mutual post-filters.  −1 indices mean "no match".
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..features.frame import FrameFeatures
from ..geometry import se3
from ..geometry.camera import CameraParams, project
from ..ops.hamming import hamming_matrix
from ..utils import topk_bounded

BIG = 1 << 20
INT32_MAX = (1 << 31) - 1


class MatchResult(NamedTuple):
    """Per-query match: index into the target set (−1 = none) and distance."""

    idx: torch.Tensor    # i32[Q]
    dist: torch.Tensor   # i32[Q]

    @property
    def found(self) -> torch.Tensor:
        return self.idx >= 0


def best_match(dist: torch.Tensor, cand_mask: torch.Tensor, max_dist: int, ratio: float) -> MatchResult:
    """Masked best/second-best selection with ratio test per query row
    (getBestMatch + ``best < th && best/second < ratio``); ``dist`` and
    ``cand_mask`` are [..., Q, T]."""
    masked = torch.where(cand_mask, dist, BIG)
    best = torch.amin(masked, dim=-1)
    best_idx = torch.argmin(masked, dim=-1)
    cols = torch.arange(masked.shape[-1], device=masked.device)
    second = torch.amin(torch.where(cols == best_idx[..., None], BIG, masked), dim=-1)
    ok = (best <= max_dist) & (best.float() < ratio * second.float())
    return MatchResult(idx=torch.where(ok, best_idx, -1).to(torch.int32), dist=best)


def mutual_filter(match_qt: MatchResult, n_target: int) -> MatchResult:
    """Keep only matches where each target is claimed by a single best query:
    per target, the claiming query with the smallest (distance, index) key.
    Leading dimensions of ``match_qt`` are batch."""
    *lead, q = match_qt.idx.shape
    dev = match_qt.idx.device
    tgt = torch.where(match_qt.found, match_qt.idx, n_target).long()
    order_key = torch.clamp(match_qt.dist, max=300) * (q + 1) + torch.arange(q, device=dev, dtype=torch.int32)
    best_key = torch.full((*lead, n_target + 1), INT32_MAX, dtype=torch.int32, device=dev)
    best_key = best_key.scatter_reduce(-1, tgt, order_key.to(torch.int32), reduce="amin")
    keep = match_qt.found & (best_key.gather(-1, tgt) == order_key)
    return MatchResult(idx=torch.where(keep, match_qt.idx, -1), dist=match_qt.dist)


def rotation_consistency(
    angle_q: torch.Tensor,
    angle_t_of_match: torch.Tensor,
    found: torch.Tensor,
    n_bins: int = 30,
    n_keep: int = 3,
) -> torch.Tensor:
    """Keep matches whose angle difference falls in the ``n_keep``
    most-populated histogram bins (reference verifyAngle); one histogram per
    leading index of ``found``."""
    diff = torch.remainder(angle_q - angle_t_of_match, 360.0)
    bins = torch.clamp((diff / (360.0 / n_bins)).to(torch.int32), 0, n_bins - 1).long()
    bins = bins.expand(found.shape)
    lead = found.shape[:-1]
    counts = torch.zeros((*lead, n_bins), dtype=torch.int32, device=bins.device)
    counts = counts.scatter_add(-1, bins, found.to(torch.int32))
    topv, topi = topk_bounded(counts, n_keep)
    good_bin = torch.zeros((*lead, n_bins), dtype=torch.bool, device=bins.device)
    good_bin = good_bin.scatter(-1, topi, topv > 0)
    return found & good_bin.gather(-1, bins)


def area_candidates(
    query_uv: torch.Tensor,
    query_octave: torch.Tensor,
    target: FrameFeatures,
    radius,
    min_octave: torch.Tensor,
    max_octave: torch.Tensor,
    scale_factor: float,
) -> torch.Tensor:
    """Dense findFeaturesInArea: mask [Q, T] of target keypoints within
    ``radius · scale^octave_q`` of each query, inside the octave window."""
    r = radius * torch.pow(scale_factor, query_octave.float())
    du = (query_uv[:, None, 0] - target.uv[None, :, 0]).abs()
    dv = (query_uv[:, None, 1] - target.uv[None, :, 1]).abs()
    in_area = (du <= r[:, None]) & (dv <= r[:, None])
    oct_ok = (target.octave[None, :] >= min_octave[:, None]) & (target.octave[None, :] <= max_octave[:, None])
    return in_area & oct_ok & target.valid[None, :]


def forward_backward_octaves(
    query_octave: torch.Tensor, z_forward: torch.Tensor, baseline: float, n_levels: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward motion → [oct, max]; backward → [0, oct]; else ±1
    (ORBMatcher.cc:271-309)."""
    up = z_forward > baseline
    down = z_forward < -baseline
    zero = torch.zeros_like(query_octave)
    top = torch.full_like(query_octave, n_levels - 1)
    lo = torch.where(up, query_octave, torch.where(down, zero, torch.clamp(query_octave - 1, min=0)))
    hi = torch.where(up, top, torch.where(down, query_octave, torch.clamp(query_octave + 1, max=n_levels - 1)))
    return lo, hi


def search_by_area(
    prev: FrameFeatures,
    prev_has_mp: torch.Tensor,
    cur: FrameFeatures,
    cur_has_mp: torch.Tensor,
    z_forward: torch.Tensor,
    *,
    radius: float,
    scale_factor: float,
    n_levels: int,
    baseline: float,
    max_dist: int,
    ratio: float,
    check_rotation: bool = True,
) -> MatchResult:
    """Motion-model matching around the previous keypoints' image positions
    (ORBMatcher.cc:266-347): each previous keypoint carrying a map point
    finds its best current keypoint nearby, current keypoints that already
    hold one excluded (:321-334).  Returns per-previous-keypoint indices into
    the current frame."""
    lo, hi = forward_backward_octaves(prev.octave, z_forward, baseline, n_levels)
    cand = area_candidates(prev.uv, prev.octave, cur, radius, lo, hi, scale_factor)
    cand = cand & prev.valid[:, None] & prev_has_mp[:, None] & (~cur_has_mp)[None, :]
    m = best_match(hamming_matrix(prev.desc, cur.desc), cand, max_dist, ratio)
    if check_rotation:
        keep = rotation_consistency(prev.angle, cur.angle[m.idx.clamp(min=0).long()], m.found)
        m = MatchResult(idx=torch.where(keep, m.idx, -1), dist=m.dist)
    return mutual_filter(m, cur.capacity)


def mappoint_visibility(
    cam: CameraParams,
    Tcw: torch.Tensor,
    mp_pos: torch.Tensor,
    mp_normal: torch.Tensor,
    mp_min_dist: torch.Tensor,
    mp_max_dist: torch.Tensor,
    *,
    width: int,
    height: int,
    scale_factor: float,
    n_levels: int,
):
    """MapPoint::isInVision + predictLevel, batched (MapPoint.cc:141-171,
    :191-201): (uv [M,2], visible [M], pred_octave [M], cos_view [M]).  A
    pose batch ``Tcw [..., 4, 4]`` takes points ``[..., M, 3]``."""
    pc = se3.apply(Tcw if Tcw.dim() == 2 else Tcw[..., None, :, :], mp_pos)
    uv, in_front = project(cam, pc)
    in_img = (uv[..., 0] >= 0) & (uv[..., 0] < width) & (uv[..., 1] >= 0) & (uv[..., 1] < height)
    Twc = se3.inverse(Tcw)
    ray = mp_pos - se3.t_of(Twc)[..., None, :]
    dist = torch.linalg.vector_norm(ray, dim=-1)
    dist_ok = (dist >= 0.8 * mp_min_dist) & (dist <= 1.2 * mp_max_dist)
    cos_view = torch.sum(ray * mp_normal, dim=-1) / torch.clamp(dist, min=1e-9)
    angle_ok = cos_view >= 0.5
    level = torch.ceil(
        torch.log(torch.clamp(mp_max_dist / torch.clamp(dist, min=1e-9), min=1e-9))
        / float(np.log(np.float32(scale_factor)))
    ).to(torch.int32)
    level = torch.clamp(level, 0, n_levels - 1)
    visible = in_front & in_img & dist_ok & angle_ok
    return uv, visible, level, cos_view


def search_mappoints_projection(
    cam: CameraParams,
    Tcw: torch.Tensor,
    mp_pos: torch.Tensor,
    mp_normal: torch.Tensor,
    mp_min_dist: torch.Tensor,
    mp_max_dist: torch.Tensor,
    mp_desc: torch.Tensor,
    mp_valid: torch.Tensor,
    cur: FrameFeatures,
    cur_has_mp: torch.Tensor,
    *,
    th: float,
    width: int,
    height: int,
    scale_factor: float,
    n_levels: int,
    max_dist: int,
    ratio: float,
    exclude_taken: bool = True,
    precomputed_vis=None,
) -> MatchResult:
    """Local-map tracking search (ORBMatcher.cc:561-612): project map points,
    radius 2.5 (cos > 0.998) or 4.0, ×th, scaled by the predicted level,
    octave ±1 around it, ratio + threshold gates.  Returns per-map-point
    match indices into the current frame.  Leading dimensions of ``Tcw``,
    the map-point tables and ``cur_has_mp`` are batch (one search per pose
    against the same frame)."""
    if precomputed_vis is not None:
        uv, visible, level, cos_view = precomputed_vis
    else:
        uv, visible, level, cos_view = mappoint_visibility(
            cam, Tcw, mp_pos, mp_normal, mp_min_dist, mp_max_dist,
            width=width, height=height, scale_factor=scale_factor, n_levels=n_levels,
        )
    base_r = torch.where(cos_view > 0.998, 2.5, 4.0) * th
    r = base_r * torch.pow(scale_factor, level.float())
    du = (uv[..., :, None, 0] - cur.uv[None, :, 0]).abs()
    dv = (uv[..., :, None, 1] - cur.uv[None, :, 1]).abs()
    in_area = (du <= r[..., None]) & (dv <= r[..., None])
    oct_ok = (cur.octave[None, :] >= torch.clamp(level - 1, min=0)[..., None]) & (
        cur.octave[None, :] <= torch.clamp(level + 1, max=n_levels - 1)[..., None]
    )
    cand = in_area & oct_ok & cur.valid[None, :] & visible[..., None] & mp_valid[..., None]
    if exclude_taken:
        cand = cand & (~cur_has_mp)[..., None, :]
    dist = hamming_matrix(mp_desc, cur.desc)
    m = best_match(dist, cand, max_dist, ratio)
    return mutual_filter(m, cur.capacity)
