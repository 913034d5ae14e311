"""Loop closing: detection, Sim3 verification, correction, optimization.

Port of ``orb_slam2_ros2_tpu/pipeline/loop_closing.py`` (reference
src/LoopClosing.cc, src/KeyFrameDB.cc):

- ``detect_async`` / ``detect_resolve``: keyframe-database registration and
  retrieval on the device, read back later through a pinned host buffer,
  then the host's covisibility-consistency chains of ≥ 3 consecutive
  detections (LoopClosing.cc:218-282);
- ``sim3_begin`` / ``sim3_step``: the Sim3 verification cascade in three
  stages, one per idle frame — descriptor match + Sim3 RANSAC ≥ 20,
  searchBySim3 expansion ≥ 50 + OptimizeSim3 ≥ 50, loop-group projection
  ≥ 40 (LoopClosing.cc:300-415, ORBMatcher.cc:370-549);
- ``correct``: the current covisibility group dragged along the loop Sim3,
  the matched loop points fused, the loop group fused into the current
  neighbourhood, the essential graph optimized (LoopClosing.cc:432-541).
  The global BA then runs in the background (``solvers/global_ba.py``).

Every stage takes host ints for keyframe ids and never writes into the map
it is given.  A stage's results stay on the device; its few gate counts go
to a pinned host buffer behind a CUDA event and are read on a later frame.
The mesh-sharded essential graph and global BA wait for the multi-GPU item
of the port queue.
"""

from __future__ import annotations

import contextlib
from functools import partial
from typing import List, Optional, Set, Tuple

import numpy as np
import torch

from ..bow.keyframe_db import KeyFrameDB, add_keyframe, find_loop_candidates, sparse_bow
from ..bow.vocabulary import Vocabulary, transform
from ..config import SLAMConfig
from ..geometry import se3, sim3
from ..geometry.camera import CameraParams, project
from ..mapstate.local_map import LocalMap
from ..mapstate.map_state import (
    INT32_MAX,
    MapState,
    _append_observations,
    _covis_row_for_kf,
    _distill_descriptors,
    kf_index,
    merge_mappoints,
)
from ..mapstate.mapping import _set_covis_row, fuse_candidates_into_keyframe
from ..matching.matcher import BIG, best_match, mutual_filter
from ..ops.hamming import hamming_matrix
from ..solvers.global_ba import global_ba
from ..solvers.pose_graph import PoseGraphProblem, _take, make_relative_measurements, optimize_pose_graph
from ..solvers.sim3_solver import optimize_sim3, ransac_sim3
from ..utils import mask_from_ids, set_drop, topk_bounded


class HostCopy:
    """A device tensor on its way to the host: a ``non_blocking`` copy into
    pinned memory behind a CUDA event (a copy to pageable memory would
    synchronise at once).  ``numpy()`` waits for the event."""

    def __init__(self, t: torch.Tensor):
        if t.is_cuda:
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = t.clone(), None

    @property
    def on_device(self) -> bool:
        return self._event is not None

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def _fetch(x) -> np.ndarray:
    """Host array of a ``HostCopy``, a tensor or anything array-like."""
    if isinstance(x, HostCopy):
        return x.numpy()
    if torch.is_tensor(x):
        return x.cpu().numpy()
    return np.asarray(x)


def _log_scale(scale_factor: float) -> float:
    return float(np.log(np.float32(scale_factor)))


def match_mappoint_features(state: MapState, kf1: int, kf2: int, *, max_dist: int = 50,
                            ratio: float = 0.75):
    """Dense hamming matching between the map-point-bearing features of two
    keyframes (in place of the BoW-bucketed searchByBow,
    LoopClosing.cc:315-320): best + ratio + mutual best.  Returns (ok, bj,
    pc1, pc2, oct1, oct2, mp1, mp2) per feature of ``kf1``."""
    N = state.kf_uv.shape[1]
    M = state.mp_capacity
    dev = state.kf_uv.device
    has1 = state.kf_feat_valid[kf1] & (state.kf_mp_idx[kf1] >= 0)
    has2 = state.kf_feat_valid[kf2] & (state.kf_mp_idx[kf2] >= 0)
    masked = torch.where(has1[:, None] & has2[None, :],
                         hamming_matrix(state.kf_desc[kf1], state.kf_desc[kf2]), BIG)
    best = masked.amin(dim=1)
    bj = masked.argmin(dim=1)
    cols = torch.arange(N, device=dev)
    second = torch.where(cols[None, :] == bj[:, None], BIG, masked).amin(dim=1)
    ok = (best <= max_dist) & (best.float() < ratio * second.float())
    ok = ok & (masked.argmin(dim=0)[bj] == cols)                   # mutual best

    mp1 = state.kf_mp_idx[kf1]
    mp2 = state.kf_mp_idx[kf2][bj]
    pc1 = se3.apply(state.kf_Tcw[kf1], state.mp_pos[mp1.clamp(0, M - 1).long()])
    pc2 = se3.apply(state.kf_Tcw[kf2], state.mp_pos[mp2.clamp(0, M - 1).long()])
    ok = ok & (pc1[:, 2] > 0) & (pc2[:, 2] > 0)
    return ok, bj.to(torch.int32), pc1, pc2, state.kf_octave[kf1], state.kf_octave[kf2][bj], mp1, mp2


def _predict_level(max_dist, d, scale_factor: float, n_levels: int):
    """MapPoint::predictLevel (reference MapPoint.cc:191-201)."""
    lvl = torch.ceil(torch.log(torch.clamp(max_dist / torch.clamp(d, min=1e-9), min=1e-9))
                     / _log_scale(scale_factor)).to(torch.int32)
    return torch.clamp(lvl, 0, n_levels - 1)


def _in_image(uv, width: int, height: int):
    return (uv[:, 0] >= 0) & (uv[:, 0] < width) & (uv[:, 1] >= 0) & (uv[:, 1] < height)


def search_by_sim3_pair(
    state: MapState,
    cam: CameraParams,
    kf_cur: int,
    kf_cand: int,
    S12: sim3.Sim3,
    ok: torch.Tensor,
    bj: torch.Tensor,
    *,
    width: int,
    height: int,
    scale_factor: float,
    n_levels: int,
    th: float = 7.5,
    max_dist: int = 50,
    ratio: float = 0.75,
):
    """Sim3-guided bidirectional projection matching between two keyframes
    (searchBySim3, ORBMatcher.cc:425-484): each side's map points are
    projected into the other camera through the Sim3 and matched in a
    ``th``-radius window; matches are ADDED to (ok, bj) with precedence
    existing > forward > backward, and a candidate feature claimed
    backward by several current features goes to the one of least distance
    (lowest index on ties).  Returns (ok2, bj2, n_matches)."""
    N = state.kf_uv.shape[1]
    M = state.mp_capacity
    dev = ok.device

    def side(kf):
        mp = state.kf_mp_idx[kf]
        mpc = mp.clamp(0, M - 1).long()
        has = state.kf_feat_valid[kf] & (mp >= 0) & state.mp_valid[mpc]
        pc = se3.apply(state.kf_Tcw[kf], state.mp_pos[mpc])
        return has, pc, state.mp_min_dist[mpc], state.mp_max_dist[mpc]

    has1, pc1, minD1, maxD1 = side(kf_cur)
    has2, pc2, minD2, maxD2 = side(kf_cand)
    D = hamming_matrix(state.kf_desc[kf_cur], state.kf_desc[kf_cand])
    matched2 = mask_from_ids(torch.where(ok, bj, N), N)

    def one_direction(p_src_cam, S_to_other, src_free, src_minD, src_maxD, tgt_kf, tgt_has_mp, dist):
        p_t = sim3.apply(S_to_other, p_src_cam)
        uv_t, in_front = project(cam, p_t)
        d = torch.linalg.vector_norm(p_t, dim=-1) / S_to_other.s
        dist_ok = (d >= 0.8 * src_minD) & (d <= 1.2 * src_maxD)
        lvl = _predict_level(src_maxD, d, scale_factor, n_levels)
        r = th * torch.pow(scale_factor, lvl.float())
        tgt_uv, tgt_oct = state.kf_uv[tgt_kf], state.kf_octave[tgt_kf]
        in_area = ((uv_t[:, None, 0] - tgt_uv[None, :, 0]).abs() <= r[:, None]) & (
            (uv_t[:, None, 1] - tgt_uv[None, :, 1]).abs() <= r[:, None])
        oct_ok = (tgt_oct[None, :] >= (lvl - 1)[:, None]) & (tgt_oct[None, :] <= (lvl + 1)[:, None])
        q_ok = src_free & in_front & _in_image(uv_t, width, height) & dist_ok
        return best_match(dist, in_area & oct_ok & tgt_has_mp[None, :] & q_ok[:, None], max_dist, ratio)

    fwd = one_direction(pc1, sim3.inverse(S12), has1 & ~ok, minD1, maxD1, kf_cand, has2, D)
    bwd = one_direction(pc2, S12, has2 & ~matched2, minD2, maxD2, kf_cur, has1, D.T)

    ok2 = ok
    bj2 = torch.where(ok, bj, -1)
    fill_f = ~ok2 & fwd.found
    bj2 = torch.where(fill_f, fwd.idx, bj2)
    ok2 = ok2 | fill_f
    used_cand = mask_from_ids(torch.where(ok2, bj2, N), N)
    bwd_found = bwd.found & ~used_cand
    brow = torch.where(bwd_found, bwd.idx, N).long()
    key = (torch.clamp(bwd.dist, max=300) * (N + 1) + torch.arange(N, device=dev)).to(torch.int32)
    best_key = torch.full((N + 1,), INT32_MAX, dtype=torch.int32, device=dev).scatter_reduce(
        0, brow, key, reduce="amin")[:N]
    fill_b = ~ok2 & (best_key < INT32_MAX)
    bj2 = torch.where(fill_b, best_key % (N + 1), bj2)
    ok2 = ok2 | fill_b
    return ok2, torch.where(ok2, bj2, -1).to(torch.int32), ok2.to(torch.int32).sum().to(torch.int32)


def gather_match_pairs(state: MapState, kf_cur: int, kf_cand: int, ok, bj):
    """Camera-frame point pairs + octaves of a per-current-feature match set
    (the inputs of Sim3 RANSAC / OptimizeSim3): (ok, pc1, pc2, oct1, oct2,
    mp2)."""
    M = state.mp_capacity
    bjc = bj.clamp(0, state.kf_uv.shape[1] - 1).long()
    mp1 = state.kf_mp_idx[kf_cur]
    mp2 = state.kf_mp_idx[kf_cand][bjc]
    pc1 = se3.apply(state.kf_Tcw[kf_cur], state.mp_pos[mp1.clamp(0, M - 1).long()])
    pc2 = se3.apply(state.kf_Tcw[kf_cand], state.mp_pos[mp2.clamp(0, M - 1).long()])
    ok = ok & (pc1[:, 2] > 0) & (pc2[:, 2] > 0) & (mp1 >= 0) & (mp2 >= 0)
    return ok, pc1, pc2, state.kf_octave[kf_cur], state.kf_octave[kf_cand][bjc], mp2


def loop_group_snapshot(state: MapState, kf_cand: int, *, min_covis_weight: int, max_mps: int) -> LocalMap:
    """The candidate keyframe's covisibility group and every map point it
    observes (getConnectedKfs, LoopClosing.cc:381-401), compacted to
    ``max_mps`` slots by id (lowest first)."""
    K, M = state.kf_capacity, state.mp_capacity
    dev = state.covis.device
    kf_mask = (state.covis[kf_cand] >= min_covis_weight) & state.kf_valid
    kf_mask = torch.where(torch.arange(K, device=dev) == kf_cand, state.kf_valid[kf_cand], kf_mask)
    rows = torch.where(kf_mask[:, None], state.kf_mp_idx, -1)
    mp_mask = mask_from_ids(rows, M) & state.mp_valid
    score = torch.where(mp_mask, 1 + torch.arange(M, dtype=torch.int32, device=dev), 0)
    top, mp_ids = topk_bounded(score, min(max_mps, M))
    okm = top > 0
    mp_ids = torch.where(okm, mp_ids, -1).to(torch.int32)
    idc = mp_ids.clamp(0, M - 1).long()
    return LocalMap(
        mp_ids=mp_ids, pos=state.mp_pos[idc], normal=state.mp_normal[idc], desc=state.mp_desc[idc],
        min_dist=state.mp_min_dist[idc], max_dist=state.mp_max_dist[idc], valid=okm,
        kf_ids=torch.zeros(1, dtype=torch.int32, device=dev), kf_mask=kf_mask,
    )


def search_loop_group_projection(
    state: MapState,
    cam: CameraParams,
    kf_cur: int,
    S_cw: sim3.Sim3,
    group: LocalMap,
    matched_mp: torch.Tensor,
    *,
    width: int,
    height: int,
    scale_factor: float,
    n_levels: int,
    th: float = 10.0,
    max_dist: int = 50,
    ratio: float = 0.75,
):
    """Project the loop group's map points into the current keyframe through
    Scw (the second searchBySim3, ORBMatcher.cc:501-549): distance, view
    angle and level gates, a ``th``-radius window over the current features
    that carry no verified match yet, hamming ≤ 50 + ratio, one point per
    feature.  Returns (matched_mp', n_total)."""
    N = state.kf_uv.shape[1]
    M = state.mp_capacity
    already = mask_from_ids(torch.where(matched_mp >= 0, matched_mp, M), M)
    fresh = group.valid & ~already[group.mp_ids.clamp(0, M - 1).long()]

    p_c = sim3.apply(S_cw, group.pos)
    uv_c, in_front = project(cam, p_c)
    dws = torch.linalg.vector_norm(p_c, dim=-1)
    d = dws / S_cw.s
    dist_ok = (d >= 0.8 * group.min_dist) & (d <= 1.2 * group.max_dist)
    n_c = torch.einsum("ij,lj->li", S_cw.R, group.normal)
    angle_ok = torch.sum(n_c * p_c, dim=-1) >= 0.5 * dws
    lvl = _predict_level(group.max_dist, d, scale_factor, n_levels)
    r = th * torch.pow(scale_factor, lvl.float())

    cur_uv, cur_oct = state.kf_uv[kf_cur], state.kf_octave[kf_cur]
    in_area = ((uv_c[:, None, 0] - cur_uv[None, :, 0]).abs() <= r[:, None]) & (
        (uv_c[:, None, 1] - cur_uv[None, :, 1]).abs() <= r[:, None])
    oct_ok = (cur_oct[None, :] >= (lvl - 1)[:, None]) & (cur_oct[None, :] <= (lvl + 1)[:, None])
    q_ok = fresh & in_front & _in_image(uv_c, width, height) & dist_ok & angle_ok
    cand = (in_area & oct_ok & state.kf_feat_valid[kf_cur][None, :]
            & (matched_mp < 0)[None, :] & q_ok[:, None])
    m = best_match(hamming_matrix(group.desc, state.kf_desc[kf_cur]), cand, max_dist, ratio)
    m = mutual_filter(m, N)
    matched_mp2 = set_drop(matched_mp, torch.where(m.found, m.idx, N), group.mp_ids)
    return matched_mp2, (matched_mp2 >= 0).to(torch.int32).sum().to(torch.int32)


def attach_matched_mps(state: MapState, kf_cur: int, matched_mp: torch.Tensor) -> MapState:
    """Fuse the Sim3-matched loop points into the current keyframe (reference
    correctLoop, LoopClosing.cc:497-513): empty feature slots adopt the loop
    point; occupied ones merge, the current keyframe's own point surviving
    (MapPoint::replace(pMpC, matched), :507)."""
    N, M = state.kf_uv.shape[1], state.mp_capacity
    dev = matched_mp.device
    k = kf_index(kf_cur, dev)
    cur_mp = state.kf_mp_idx[kf_cur]
    valid_m = (matched_mp >= 0) & state.mp_valid[matched_mp.clamp(0, M - 1).long()]
    attach = valid_m & (cur_mp < 0) & state.kf_feat_valid[kf_cur]
    feats = torch.arange(N, dtype=torch.int32, device=dev)
    row = set_drop(cur_mp, torch.where(attach, feats, N), matched_mp)
    st = state._replace(kf_mp_idx=state.kf_mp_idx.index_copy(0, k, row[None]))
    st = _append_observations(st, k, matched_mp, feats, attach)

    merge = valid_m & (cur_mp >= 0) & (cur_mp != matched_mp)
    st = merge_mappoints(st, winner=cur_mp, loser=matched_mp, mask=merge)
    st = _distill_descriptors(st, torch.where(attach | merge, torch.where(merge, cur_mp, matched_mp), -1))
    return st._replace(covis=_set_covis_row(st.covis, k, _covis_row_for_kf(st, k)))


def fuse_group_into_kfs(
    state: MapState,
    cam: CameraParams,
    group: LocalMap,
    kf_ids,
    *,
    width: int,
    height: int,
    scale_factor: float,
    n_levels: int,
) -> MapState:
    """Project the loop group's points into each keyframe of ``kf_ids`` (host
    ints; negative ones are skipped) and fuse with loop priority (reference
    LoopClosing.cc:515-517: matcher.fuse(pKf, mvLoopGroupMps, map, true, 4.0))."""
    for kf in kf_ids:
        if kf >= 0:
            state = fuse_candidates_into_keyframe(
                state, int(kf), cam, group, width=width, height=height, scale_factor=scale_factor,
                n_levels=n_levels, th=4.0, max_dist=50, ratio=0.8, loop_priority=True,
            )
    return state


def correct_group(state: MapState, kf_cur: int, kf_cand: int, S12: sim3.Sim3, *,
                  min_covis_weight: int) -> Tuple[MapState, sim3.Sim3, torch.Tensor]:
    """Pose/point correction of the current covisibility group
    (LoopClosing.cc:458-513): the current keyframe's corrected pose is
    S12 ∘ T_cand_w, its group follows through the old relative poses, and
    each point owned (first observation) by a group member is remapped via
    S_new_wc ∘ S_old_cw.  The loop edge is recorded in the first free slot
    (dropped when none is free).

    Returns (state, S_nc, group_mask), ``S_nc`` the uncorrected Sim3 poses of
    every keyframe (the reference's NonCorrectedSim3)."""
    K = state.kf_capacity
    dev = state.kf_Tcw.device
    S_cw_corr = sim3.compose(S12, sim3.from_se3(state.kf_Tcw[kf_cand]))
    S_cw_old = sim3.from_se3(state.kf_Tcw[kf_cur])
    kf_ids = torch.arange(K, device=dev)
    group_mask = ((state.covis[kf_cur] >= min_covis_weight) & state.kf_valid) | (kf_ids == kf_cur)

    S_all = sim3.from_se3(state.kf_Tcw)
    S_corr = sim3.compose(sim3.compose(S_all, sim3.inverse(S_cw_old)), S_cw_corr)
    kf_Tcw = torch.where(group_mask[:, None, None], sim3.to_se3(S_corr), state.kf_Tcw)

    obs0 = state.mp_obs_kf[:, 0].clamp(0, K - 1).long()
    owner_in_group = group_mask[obs0] & state.mp_valid
    p_new = sim3.apply(sim3.inverse(_take(S_corr, obs0)), sim3.apply(_take(S_all, obs0), state.mp_pos))
    mp_pos = torch.where(owner_in_group[:, None], p_new, state.mp_pos)

    E = state.loop_edges.shape[0]
    free = (state.loop_edges[:, 0] < 0).to(torch.int32)
    slot = torch.where(free.sum() > 0, torch.argmax(free), E).reshape(1)
    pair = torch.arange(2, dtype=torch.int32, device=dev)
    pair = torch.where(pair == 0, kf_cur, kf_cand).to(torch.int32)[None]
    loop_edges = set_drop(state.loop_edges, slot, pair)
    return state._replace(kf_Tcw=kf_Tcw, mp_pos=mp_pos, loop_edges=loop_edges), S_all, group_mask


def collect_essential_edges(state: MapState, essential_weight: int, max_edges: int):
    """Essential-graph edges: spanning tree ∪ strongest covisibility
    (≥ ``essential_weight``) ∪ loop edges, padded with −1 (reference
    Optimizer.cc:790-877); the LAST slot is reserved for the new loop
    constraint.  Returns (ei, ej, weight)."""
    K = state.kf_capacity
    dev = state.covis.device
    parent = state.kf_parent
    tree_ok = (parent >= 0) & state.kf_valid
    iu = torch.triu_indices(K, K, offset=1, device=dev)
    w = state.covis[iu[0], iu[1]]
    covis_ok = (w >= essential_weight) & state.kf_valid[iu[0]] & state.kf_valid[iu[1]]
    score = torch.where(covis_ok, w, 0)
    E_loop = state.loop_edges.shape[0]
    n_covis = max(0, min(max_edges - K - E_loop - 1, int(score.shape[0])))
    topw, topi = topk_bounded(score, n_covis)
    cov_i = torch.where(topw > 0, iu[0][topi], -1)
    cov_j = torch.where(topw > 0, iu[1][topi], -1)

    le = state.loop_edges
    le_ok = ((le[:, 0] >= 0) & state.kf_valid[le[:, 0].clamp(0, K - 1).long()]
             & state.kf_valid[le[:, 1].clamp(0, K - 1).long()])
    none = torch.full((1,), -1, dtype=torch.int32, device=dev)
    ei = torch.cat([torch.where(tree_ok, parent, -1), cov_i.to(torch.int32),
                    torch.where(le_ok, le[:, 0], -1), none])
    ej = torch.cat([torch.where(tree_ok, torch.arange(K, dtype=torch.int32, device=dev), -1),
                    cov_j.to(torch.int32), torch.where(le_ok, le[:, 1], -1), none])
    return ei, ej, torch.ones(ei.shape, dtype=torch.float32, device=dev)


def optimize_essential(
    state: MapState,
    kf_cur: int,
    kf_cand: int,
    S12: sim3.Sim3,
    S_nc: sim3.Sim3,
    group_mask: torch.Tensor,
    pre_conn: torch.Tensor,
    *,
    essential_weight: int,
    pose_graph_fn,
    max_edges: int = 8192,
    max_new_conn: int = 256,
) -> MapState:
    """Essential-graph optimization after correction + fuse.  Drift edges
    (spanning tree ∪ loop edges ∪ covis ≥ 100) are measured from the
    uncorrected poses ``S_nc`` (Optimizer.cc:836-877); the new cross-loop
    connections the fuse created (group keyframe ↔ outside, unconnected
    before, weight ≥ 100 now) from the corrected ones (:804-833); the loop
    edge carries S12.  Poses commit as SE3, points via S_wc_new ∘ S_cw_old
    (:898-918)."""
    K = state.kf_capacity
    dev = state.kf_Tcw.device
    S_now = sim3.from_se3(state.kf_Tcw)
    budget = max(max_edges - max_new_conn, K + state.loop_edges.shape[0] + 1 + 256)
    ei, ej, ew = collect_essential_edges(state, essential_weight, budget)
    n_collect = ei.shape[0]
    S_meas = make_relative_measurements(S_nc, ei.clamp(min=0), ej.clamp(min=0))

    valid_kf = state.kf_valid
    new_mask = (group_mask[:, None] & ~group_mask[None, :] & ~pre_conn
                & (state.covis >= essential_weight) & valid_kf[:, None] & valid_kf[None, :])
    topw, topi = topk_bounded(torch.where(new_mask, state.covis, 0).reshape(-1), max_new_conn)
    ni = torch.where(topw > 0, topi // K, -1).to(torch.int32)
    nj = torch.where(topw > 0, topi % K, -1).to(torch.int32)
    S_meas_new = make_relative_measurements(S_now, ni.clamp(min=0), nj.clamp(min=0))

    # the loop edge S_cur←cand at the slot collect_essential_edges reserved
    sel = torch.arange(n_collect + ni.shape[0], device=dev) == n_collect - 1
    ei = torch.where(sel, kf_cand, torch.cat([ei, ni])).to(torch.int32)
    ej = torch.where(sel, kf_cur, torch.cat([ej, nj])).to(torch.int32)
    ew = torch.cat([ew, torch.ones(ni.shape, dtype=torch.float32, device=dev)])
    S_meas = sim3.Sim3(
        R=torch.where(sel[:, None, None], S12.R, torch.cat([S_meas.R, S_meas_new.R])),
        t=torch.where(sel[:, None], S12.t, torch.cat([S_meas.t, S_meas_new.t])),
        s=torch.where(sel, S12.s, torch.cat([S_meas.s, S_meas_new.s])),
    )
    fixed = (torch.arange(K, device=dev) == kf_cand) | ~valid_kf
    prob = PoseGraphProblem(
        S_cw=S_now, kf_valid=valid_kf, kf_fixed=fixed, edge_i=ei.clamp(min=0), edge_j=ej.clamp(min=0),
        edge_Sji=S_meas, edge_valid=(ei >= 0) & (ej >= 0), edge_weight=ew,
    )
    S_opt = pose_graph_fn(prob)

    obs0 = state.mp_obs_kf[:, 0].clamp(0, K - 1).long()
    p_new = sim3.apply(sim3.inverse(_take(S_opt, obs0)), sim3.apply(_take(S_now, obs0), state.mp_pos))
    return state._replace(
        kf_Tcw=torch.where(valid_kf[:, None, None], sim3.to_se3(S_opt), state.kf_Tcw),
        mp_pos=torch.where(state.mp_valid[:, None], p_new, state.mp_pos),
    )


@contextlib.contextmanager
def _no_span(name: str):
    yield


class LoopCloser:
    """The loop closer: vocabulary, keyframe database, consistency chains
    and the deferred Sim3 cascade.  ``span`` (name → context manager) wraps
    each stage; the system sets it to time them."""

    def __init__(self, cfg: SLAMConfig, vocab: Vocabulary):
        self.cfg = cfg
        self.vocab = vocab
        self.device = vocab.device
        self.db = KeyFrameDB.empty(cfg.map.max_keyframes, cfg.bow.max_words_per_query, device=self.device)
        # consistency chains: (covisibility-group set, consecutive count)
        self.consistent_groups: List[Tuple[Set[int], int]] = []
        self.last_loop_kf = -1
        self.pending_sim3 = None   # the cascade in flight (sim3_begin / sim3_step)
        # waits for a copied detection or gate: host reads that the sync
        # debug mode does not report
        self.host_reads = 0
        # (kf_cur, kf_cand, stage, gate counts) of every stage read back
        self.gate_log: list = []
        self.span = _no_span
        o, c = cfg.orb, cfg.camera
        self._geom = dict(width=c.width, height=c.height, scale_factor=o.scale_factor, n_levels=o.n_levels)
        self._fix_scale = c.camera_type in (0, 1)   # stereo / RGB-D: bFixScale

    def grow(self, n_keyframes: int) -> None:
        """Re-pad the sparse BoW rows when the map's keyframe capacity grows
        (SLAM._grow); row ids are stable, so existing entries carry over."""
        dK = n_keyframes - self.db.word_ids.shape[0]
        if dK <= 0:
            return
        more = KeyFrameDB.empty(dK, self.db.max_words, device=self.db.word_ids.device)
        self.db = KeyFrameDB(
            word_ids=torch.cat([self.db.word_ids, more.word_ids]),
            weights=torch.cat([self.db.weights, more.weights]),
        )

    def add_keyframe_to_db(self, state: MapState, kf_id: int) -> None:
        self.db = add_keyframe(self.db, self.vocab, kf_id, state.kf_desc[kf_id], state.kf_feat_valid[kf_id])

    def _read(self, x) -> np.ndarray:
        self.host_reads += isinstance(x, HostCopy) and x.on_device
        return _fetch(x)

    # ------------------------------------------------------------------
    def _candidates(self, state: MapState, query, anchor_kf: int) -> torch.Tensor:
        """Loop candidates of a BoW query anchored at ``anchor_kf``, with
        their covisibility rows: i32[5, 1 + K], the ids in column 0."""
        cand_ids, _ = find_loop_candidates(
            self.db, state, query, anchor_kf, n_candidates=5, n_words=self.vocab.n_words,
            min_covis_weight=self.cfg.mapping.min_covis_weight,
        )
        rows = state.covis[cand_ids.clamp(0, state.kf_capacity - 1).long()]
        rows = torch.where((cand_ids >= 0)[:, None], rows, 0)
        return torch.cat([cand_ids[:, None], rows], dim=1)

    def _query(self, desc, valid):
        words = transform(self.vocab, desc, valid)
        return sparse_bow(self.vocab, words, self.cfg.bow.max_words_per_query)

    def add_and_detect(self, state: MapState, kf_id: int) -> torch.Tensor:
        """Database registration + candidate query of keyframe ``kf_id``."""
        q = self._query(state.kf_desc[kf_id], state.kf_feat_valid[kf_id])
        row = kf_index(kf_id, self.device)
        self.db = KeyFrameDB(word_ids=self.db.word_ids.index_copy(0, row, q.ids[None]),
                             weights=self.db.weights.index_copy(0, row, q.weights[None]))
        return self._candidates(state, q, kf_id)

    def detect_async(self, state: MapState, kf_id: int) -> Optional[HostCopy]:
        """Register the keyframe and query the database without a host read.
        Returns the result on its way to the host, for ``detect_resolve`` on
        a later frame, or None when detection is suppressed — right after
        the start or a correction (LoopClosing.cc:222-231); the keyframe is
        registered all the same."""
        out = self.add_and_detect(state, kf_id)
        if kf_id < 10 or kf_id - self.last_loop_kf < 10:
            return None
        return HostCopy(out)

    def detect_frame_async(self, state: MapState, desc, valid, ref_kf: int) -> Optional[HostCopy]:
        """Loop-candidate query from a frame's descriptors (no registration),
        anchored at the tracking reference keyframe — detection density in
        the starved-keyframe regime (LoopConfig.frame_query_stride).  None
        while the map is young; post-closure suppression is the caller's."""
        if ref_kf < 10:
            return None
        return HostCopy(self._candidates(state, self._query(desc, valid), ref_kf))

    def detect(self, state: MapState, kf_id: int) -> Optional[int]:
        """Registration + consistency-chained detection in one call."""
        out = self.detect_async(state, kf_id)
        return None if out is None else self.detect_resolve(kf_id, out)

    def detect_resolve(self, kf_id: int, out_dev, kf_window: bool = True) -> Optional[int]:
        """Host half of detection: read the candidate rows and run the
        covisibility-consistency chains (LoopClosing.cc:218-282).
        ``kf_window=False`` for frame-level queries, whose post-closure
        suppression is frame-based at the dispatch site."""
        if kf_window and kf_id - self.last_loop_kf < 10:
            return None   # a closure landed between dispatch and resolve
        out = self._read(out_dev)
        cand_all, covis_rows = out[:, 0], out[:, 1:]
        keep = cand_all >= 0
        cand_ids = [int(c) for c in cand_all[keep]]
        covis_rows = covis_rows[keep]
        if not cand_ids:
            self.consistent_groups = []
            return None
        th = self.cfg.loop.consistency_th
        new_groups: List[Tuple[Set[int], int]] = []
        enough: List[int] = []
        for ci, c in enumerate(cand_ids):
            group = set(np.nonzero(covis_rows[ci] >= self.cfg.mapping.min_covis_weight)[0].tolist())
            group.add(c)
            best = 0
            for prev_group, count in self.consistent_groups:
                if group & prev_group:
                    best = max(best, count + 1)
            new_groups.append((group, best))
            if best + 1 >= th:
                enough.append(c)
        self.consistent_groups = new_groups
        return enough[0] if enough else None

    # ------------------------------------------------------------------
    def _inv_sigma2(self, octave):
        return torch.pow(1.0 / (self.cfg.orb.scale_factor ** 2), octave.float())

    def _pair_valid(self, state: MapState, kf_cur: int, kf_cand: int) -> torch.Tensor:
        """A keyframe culled while the deferred cascade spans idle frames
        invalidates the attempt (the reference's KeyFrame::SetBadFlag hooks)."""
        return (state.kf_valid[kf_cur] & state.kf_valid[kf_cand]).to(torch.int32)

    def stage_a(self, state: MapState, cam: CameraParams, kf_cur: int, kf_cand: int,
                generator: Optional[torch.Generator] = None, *, sets=None):
        """Descriptor match + Sim3 RANSAC: (S12, ok, bj, gates [n_matches,
        n_inliers, valid])."""
        ok, bj, pc1, pc2, oct1, oct2, _, _ = match_mappoint_features(state, kf_cur, kf_cand)
        S12, _, n_in = ransac_sim3(
            pc1, pc2, ok, cam, self._inv_sigma2(oct1), self._inv_sigma2(oct2), generator, sets=sets,
            fix_scale=self._fix_scale, chi2_th=self.cfg.ba.chi2_sim3,
        )
        n_matches = ok.to(torch.int32).sum().to(torch.int32)
        return S12, ok, bj, torch.stack([n_matches, n_in.to(torch.int32),
                                         self._pair_valid(state, kf_cur, kf_cand)])

    def stage_b(self, state: MapState, cam: CameraParams, kf_cur: int, kf_cand: int, S12, ok, bj):
        """searchBySim3 expansion + OptimizeSim3: (S12', matched_mp, gates
        [n_expanded, n_inliers, valid])."""
        ok, bj, n_exp = search_by_sim3_pair(state, cam, kf_cur, kf_cand, S12, ok, bj, th=7.5, **self._geom)
        ok2, pc1, pc2, oct1, oct2, mp2 = gather_match_pairs(state, kf_cur, kf_cand, ok, bj)
        S12b, inl2, n_in2 = optimize_sim3(
            S12, pc1, pc2, ok2, cam, self._inv_sigma2(oct1), self._inv_sigma2(oct2),
            fix_scale=self._fix_scale, chi2_th=self.cfg.ba.chi2_sim3,
        )
        matched_mp = torch.where(ok2 & inl2, mp2, -1)
        return S12b, matched_mp, torch.stack([n_exp, n_in2.to(torch.int32),
                                              self._pair_valid(state, kf_cur, kf_cand)])

    def stage_c(self, state: MapState, cam: CameraParams, kf_cur: int, kf_cand: int, S12, matched_mp):
        """Loop-group projection: (matched_mp', group, gates [n_total,
        valid])."""
        group = loop_group_snapshot(state, kf_cand, min_covis_weight=self.cfg.mapping.min_covis_weight,
                                    max_mps=8192)
        S_cw = sim3.compose(S12, sim3.from_se3(state.kf_Tcw[kf_cand]))
        matched_mp, n_total = search_loop_group_projection(
            state, cam, kf_cur, S_cw, group, matched_mp, th=10.0, **self._geom)
        return matched_mp, group, torch.stack([n_total, self._pair_valid(state, kf_cur, kf_cand)])

    def _generator(self, seed: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        return gen

    def compute_sim3(self, state: MapState, cam: CameraParams, kf_cur: int, kf_cand: int,
                     generator: Optional[torch.Generator] = None, *, sets=None):
        """The whole cascade at once: descriptor match ≥ 20 → Sim3 RANSAC ≥ 20
        → expansion ≥ 50 → OptimizeSim3 ≥ 50 → loop-group projection ≥ 40
        (LoopClosing.cc:300-415).  Returns (S12, matched_mp, group), S12
        mapping cand-camera to cur-camera, or None."""
        lc = self.cfg.loop
        if generator is None and sets is None:
            generator = self._generator(kf_cur)
        S12, ok, bj, gates = self.stage_a(state, cam, kf_cur, kf_cand, generator, sets=sets)
        n_matches, n_in, _ = gates.tolist()
        if n_matches < lc.min_bow_matches or n_in < lc.min_sim3_inliers:
            return None
        S12, matched_mp, gates = self.stage_b(state, cam, kf_cur, kf_cand, S12, ok, bj)
        n_exp, n_in2, _ = gates.tolist()
        if n_exp < lc.min_expanded_matches or n_in2 < lc.min_sim3_opt_inliers:
            return None
        matched_mp, group, gates = self.stage_c(state, cam, kf_cur, kf_cand, S12, matched_mp)
        if int(gates[0]) < lc.min_group_proj_matches:
            return None
        return S12, matched_mp, group

    # ------------------------------------------------------------------
    # The deferred cascade: one stage per idle frame, each stage's gates
    # read on the next (the reference runs the cascade on its LoopClosing
    # thread, LoopClosing.cc:53-90)
    def sim3_begin(self, state: MapState, cam: CameraParams, kf_cur: int, kf_cand: int, *,
                   sets=None) -> None:
        """Start the cascade with stage A (RANSAC draws from a generator
        seeded with ``kf_cur``, or ``sets``).  A cascade in flight keeps
        priority: the new candidate is dropped."""
        if self.pending_sim3 is not None:
            return
        gen = None if sets is not None else self._generator(kf_cur)
        with self.span("sim3_a"):
            S12, ok, bj, gates = self.stage_a(state, cam, kf_cur, kf_cand, gen, sets=sets)
        self.pending_sim3 = dict(stage="a", kf_cur=kf_cur, kf_cand=kf_cand, S12=S12, ok=ok, bj=bj,
                                 gates=HostCopy(gates))

    def sim3_step(self, state: MapState, cam: CameraParams):
        """Advance the pending cascade one stage.  Returns None while in
        flight or on rejection, or ``(kf_cur, kf_cand, S12, matched_mp,
        group)`` once stage C passes."""
        p = self.pending_sim3
        if p is None:
            return None
        lc = self.cfg.loop
        g = self._read(p["gates"]).tolist()
        kf_cur, kf_cand = p["kf_cur"], p["kf_cand"]
        self.gate_log.append((kf_cur, kf_cand, p["stage"], g))
        if p["stage"] == "a":
            n_matches, n_in, valid = g
            if not valid or n_matches < lc.min_bow_matches or n_in < lc.min_sim3_inliers:
                self.pending_sim3 = None
                return None
            with self.span("sim3_b"):
                S12, matched_mp, gates = self.stage_b(state, cam, kf_cur, kf_cand, p["S12"], p["ok"], p["bj"])
            self.pending_sim3 = dict(stage="b", kf_cur=kf_cur, kf_cand=kf_cand, S12=S12,
                                     matched_mp=matched_mp, gates=HostCopy(gates))
            return None
        if p["stage"] == "b":
            n_exp, n_in2, valid = g
            if not valid or n_exp < lc.min_expanded_matches or n_in2 < lc.min_sim3_opt_inliers:
                self.pending_sim3 = None
                return None
            with self.span("sim3_c"):
                matched_mp, group, gates = self.stage_c(state, cam, kf_cur, kf_cand, p["S12"],
                                                        p["matched_mp"])
            self.pending_sim3 = dict(stage="c", kf_cur=kf_cur, kf_cand=kf_cand, S12=p["S12"],
                                     matched_mp=matched_mp, group=group, gates=HostCopy(gates))
            return None
        n_total, valid = g
        self.pending_sim3 = None
        if not valid or n_total < lc.min_group_proj_matches:
            return None
        return kf_cur, kf_cand, p["S12"], p["matched_mp"], p["group"]

    # ------------------------------------------------------------------
    def warmup(self, state: MapState, cam: CameraParams) -> None:
        """Run detection, the three stages and the correction once on
        keyframe 0 against itself and discard the result, so that the first
        real attempt pays no one-off library load or allocation mid-run.
        The map is not written (no stage writes into its input); keyframe 0
        is registered in the database, as the JAX warm-up does."""
        self.add_and_detect(state, 0)
        S12, ok, bj, _ = self.stage_a(state, cam, 0, 0, self._generator(0))
        S12, matched_mp, _ = self.stage_b(state, cam, 0, 0, S12, ok, bj)
        matched_mp, group, _ = self.stage_c(state, cam, 0, 0, S12, matched_mp)
        saved = (self.last_loop_kf, self.consistent_groups)
        self.correct(state, cam, 0, 0, sim3.identity(device=state.kf_Tcw.device), matched_mp, group,
                     run_gba=False)
        self.last_loop_kf, self.consistent_groups = saved

    def correct(
        self,
        state: MapState,
        cam: CameraParams,
        kf_cur: int,
        kf_cand: int,
        S12: sim3.Sim3,
        matched_mp: torch.Tensor,
        group: LocalMap,
        *,
        run_gba: bool = True,
        mesh=None,
    ) -> MapState:
        """Loop correction (LoopClosing.cc:432-541): group pose/point
        propagation, matched-point fuse, loop-group fuse into the current
        keyframe's top-16 covisible neighbours (one read of its covisibility
        row), essential-graph optimization, and the synchronous global BA
        when ``run_gba``."""
        if mesh is not None:
            raise NotImplementedError(
                "the mesh-sharded essential graph is not ported yet (ROADMAP port queue: multi-GPU)")
        mw = self.cfg.mapping.min_covis_weight
        pre_conn = state.covis > 0
        with self.span("correct_group"):
            state, S_nc, group_mask = correct_group(state, kf_cur, kf_cand, S12, min_covis_weight=mw)
        with self.span("fuse"):
            state = attach_matched_mps(state, kf_cur, matched_mp)
            w = state.covis[kf_cur].cpu().numpy()
            ids = np.argsort(-w)[:16]
            ids = ids[w[ids] >= mw]
            state = fuse_group_into_kfs(state, cam, group, ids.tolist(), **self._geom)
        with self.span("optimize_essential"):
            state = optimize_essential(
                state, kf_cur, kf_cand, S12, S_nc, group_mask, pre_conn,
                essential_weight=self.cfg.loop.essential_graph_weight,
                pose_graph_fn=partial(optimize_pose_graph, iters=20),
            )
        if run_gba:
            state = global_ba(state, cam, scale_factor=self.cfg.orb.scale_factor,
                              phase_iters=tuple(self.cfg.loop.global_ba_phase_iters),
                              pcg_iters=self.cfg.ba.pcg_iters)
        self.last_loop_kf = kf_cur
        self.consistent_groups = []
        return state
