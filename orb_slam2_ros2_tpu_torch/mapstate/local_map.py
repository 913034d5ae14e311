"""Local-map snapshot and tracking counters (port of
``orb_slam2_ros2_tpu/mapstate/local_map.py``; reference
Tracking::buildLocalMap, src/Tracking.cc:277-326).

The local map is a fixed-capacity device-side snapshot: the 1st+2nd-ring
covisible keyframes, their map points scattered into an M-mask and compacted
to ``max_mps`` slots (ring-1 points first, then recency).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..utils import add_drop_, count_into, mask_from_ids, topk_bounded
from .map_state import MapState, kf_index


class LocalMap(NamedTuple):
    """Fixed-size snapshot of the current local map."""

    mp_ids: torch.Tensor     # i32[L_mp] (−1 = padding)
    pos: torch.Tensor        # f32[L_mp, 3]
    normal: torch.Tensor     # f32[L_mp, 3]
    desc: torch.Tensor       # i32[L_mp, 8]
    min_dist: torch.Tensor   # f32[L_mp]
    max_dist: torch.Tensor   # f32[L_mp]
    valid: torch.Tensor      # bool[L_mp]
    kf_ids: torch.Tensor     # i32[L_kf] local keyframes (−1 = padding)
    kf_mask: torch.Tensor    # bool[K] membership mask of local KFs


def _rings_from_weights(
    state: MapState, w: torch.Tensor, n_first: int, n_second: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ring-1 = top-``n_first`` keyframes by weight ``w [K]``; ring-2 = the
    top-``n_second`` covisibility neighbours of each ring-1 KF.  Returns the
    ring-1 id list and the combined K-mask."""
    K = state.kf_capacity
    w1, ids1 = topk_bounded(w, n_first)
    ring1 = torch.where(w1 > 0, ids1, -1)
    rows = state.covis[ring1.clamp(0, K - 1)] * state.kf_valid.to(torch.int32)[None, :]
    w2, ids2 = topk_bounded(rows, n_second)
    ring2 = torch.where((w2 > 0) & (ring1[:, None] >= 0), ids2, -1)
    mask = mask_from_ids(ring1, K) | mask_from_ids(ring2, K)
    return ring1, mask & state.kf_valid


def covisible_kfs(state: MapState, kf_id, n_first: int, n_second: int):
    """1st + 2nd ring covisible keyframes of ``kf_id`` (a host int or an int
    [1] device tensor) as a bounded id list and a K-mask (reference
    Tracking.cc:277-314)."""
    k = kf_index(kf_id, state.covis.device)
    w = state.covis.index_select(0, k)[0] * state.kf_valid.to(torch.int32)
    ring1, mask = _rings_from_weights(state, w, n_first, n_second)
    return ring1, mask.index_fill(0, k, True) & state.kf_valid


def frame_observer_weights(state: MapState, mp_ids: torch.Tensor) -> torch.Tensor:
    """Per-keyframe count of the frame's tracked map points each KF observes
    (the reference's K1 vote, Tracking.cc:277-300)."""
    K = state.kf_capacity
    obs_kf = state.mp_obs_kf[mp_ids.clamp(0, state.mp_capacity - 1).long()]  # [N, O]
    src = torch.where((mp_ids >= 0)[:, None] & (obs_kf >= 0), obs_kf, K)
    return count_into(src, K) * state.kf_valid.to(torch.int32)


def local_map_snapshot(
    state: MapState, kf_id, *, n_first: int = 10, n_second: int = 5,
    max_kfs: int = 64, max_mps: int = 16384,
) -> LocalMap:
    """Collect the local map around keyframe ``kf_id`` (a host int or an int
    [1] device tensor) into fixed-size arrays."""
    ring1, kf_mask = covisible_kfs(state, kf_id, n_first, n_second)
    return _snapshot_from_mask(state, ring1, kf_mask, max_kfs=max_kfs, max_mps=max_mps)


def local_map_snapshot_frame(
    state: MapState, mp_ids: torch.Tensor, *, n_first: int = 10,
    n_second: int = 5, max_kfs: int = 64, max_mps: int = 16384,
) -> LocalMap:
    """Frame-centred local map: ring-1 = the keyframes observing the most of
    the frame's tracked points, ring-2 = their best covisibility neighbours."""
    w = frame_observer_weights(state, mp_ids)
    ring1, kf_mask = _rings_from_weights(state, w, n_first, n_second)
    return _snapshot_from_mask(state, ring1, kf_mask, max_kfs=max_kfs, max_mps=max_mps)


def _snapshot_from_mask(
    state: MapState, ring1: torch.Tensor, kf_mask: torch.Tensor, *, max_kfs: int, max_mps: int
) -> LocalMap:
    K = state.kf_capacity
    M = state.mp_capacity
    dev = kf_mask.device
    kf_score = kf_mask.to(torch.int32) * (K - torch.arange(K, dtype=torch.int32, device=dev))
    kfv, kf_ids_all = topk_bounded(kf_score, max_kfs)
    kf_ids = torch.where((kfv > 0) & kf_mask[kf_ids_all], kf_ids_all, -1)

    # mask of map points observed by local KFs
    rows = state.kf_mp_idx[kf_ids.clamp(0, K - 1)]  # [max_kfs, N]
    rows = torch.where((kf_ids >= 0)[:, None], rows, -1)
    mp_mask = mask_from_ids(rows, M) & state.mp_valid
    # ring-1 points survive the capacity cap first (revisits see OLD ids)
    r1_rows = state.kf_mp_idx[ring1.clamp(0, K - 1)]
    r1_rows = torch.where((ring1 >= 0)[:, None], r1_rows, -1)
    r1_mask = mask_from_ids(r1_rows, M)

    # compact to max_mps slots: ring-1 membership first, then recency
    score = torch.where(mp_mask, 1 + torch.arange(M, dtype=torch.int32, device=dev), 0)
    score = torch.where(mp_mask & r1_mask, score + M, score)
    top, mp_ids = topk_bounded(score, max_mps)
    ok = top > 0
    mp_ids = torch.where(ok, mp_ids, -1)
    idc = mp_ids.clamp(0, M - 1)
    return LocalMap(
        mp_ids=mp_ids.to(torch.int32),
        pos=state.mp_pos[idc],
        normal=state.mp_normal[idc],
        desc=state.mp_desc[idc],
        min_dist=state.mp_min_dist[idc],
        max_dist=state.mp_max_dist[idc],
        valid=ok,
        kf_ids=kf_ids.to(torch.int32),
        kf_mask=kf_mask,
    )


def bump_tracking_counters(
    state: MapState, local: LocalMap, visible: torch.Tensor, found: torch.Tensor
) -> MapState:
    """Update per-MP visible/found counters in place (reference
    MapPoint::addMatchInTrack/addInViewInTrack, MapPoint.h:210-253).  The
    JAX version donates the map buffer to the frame program; here the
    counters are updated in place instead."""
    M = state.mp_capacity
    add_drop_(state.mp_visible, torch.where(local.valid & visible, local.mp_ids, M), 1)
    add_drop_(state.mp_found, torch.where(local.valid & found, local.mp_ids, M), 1)
    return state
