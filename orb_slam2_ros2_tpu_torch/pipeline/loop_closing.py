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
  The essential graph is ``EssentialGraph``: three captured CUDA graphs on
  the card (JAX jits it as ``_essential``, and over a mesh as
  ``_essential_mesh``); over a mesh that ``Mesh.capturable`` refuses its
  sharded GN step runs eagerly between the captured problem and commit.

The module functions take keyframe ids as host ints or int [1] device
tensors and gather with them on the device, and none writes into the map it
is given.  ``LoopGraphs`` runs detection, the three stages, the group
correction with the matched-point fuse, and each loop-group fuse as captured
CUDA graphs on the card (JAX jits them), ids as int32 [1] tensors, writing
the database row and the corrected map into their storage in place.  A
stage's results stay on the device; its few gate counts go to a pinned host
buffer behind a CUDA event and are read on a later frame.  With a device
``mesh`` (``parallel/mesh.py``) ``correct`` shards the essential graph's
edges and the synchronous global BA's points over it.
"""

from __future__ import annotations

import contextlib
from functools import partial
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..bow.keyframe_db import BowVec, KeyFrameDB, find_loop_candidates, sparse_bow, write_row_
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
from ..mapstate.mapping import _row, _set_covis_row, fuse_candidates_into_keyframe
from ..matching.matcher import BIG, best_match, mutual_filter
from ..ops.hamming import hamming_matrix
from ..solvers.epnp import uniform_draw
from ..solvers import pose_graph
from ..solvers.global_ba import global_ba
from ..solvers.pose_graph import (
    CG_ITERS,
    DAMPING,
    DENSE_MAX_K,
    PoseGraphProblem,
    _pad_edges,
    _shard_edges,
    _take,
    gn_step,
    make_relative_measurements,
    optimize_pose_graph,
)
from ..solvers.sim3_solver import optimize_sim3, ransac_sim3
from ..utils import mask_from_ids, set_drop, topk_bounded
from .frame_graph import StepGraph, donating, id_tensor, tree_leaves
from .trace import Tracer


class HostCopy:
    """A device tensor on its way to the host: a ``non_blocking`` copy into
    pinned memory behind a CUDA event (a copy to pageable memory would
    synchronise at once).  ``numpy()`` waits for the event.  The pinned
    buffer and the event are new unless given (a reused pinned slot)."""

    def __init__(self, t: torch.Tensor, host: Optional[torch.Tensor] = None,
                 event: Optional[torch.cuda.Event] = None):
        if t.is_cuda:
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True) if host is None else host
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event() if event is None else event
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


def match_mappoint_features(state: MapState, kf1, kf2, *, max_dist: int = 50,
                            ratio: float = 0.75):
    """Dense hamming matching between the map-point-bearing features of two
    keyframes (in place of the BoW-bucketed searchByBow,
    LoopClosing.cc:315-320): best + ratio + mutual best.  Returns (ok, bj,
    pc1, pc2, oct1, oct2, mp1, mp2) per feature of ``kf1``."""
    N = state.kf_uv.shape[1]
    M = state.mp_capacity
    dev = state.kf_uv.device
    k1, k2 = kf_index(kf1, dev), kf_index(kf2, dev)
    mp1, mp2_all = _row(state.kf_mp_idx, k1), _row(state.kf_mp_idx, k2)
    has1 = _row(state.kf_feat_valid, k1) & (mp1 >= 0)
    has2 = _row(state.kf_feat_valid, k2) & (mp2_all >= 0)
    masked = torch.where(has1[:, None] & has2[None, :],
                         hamming_matrix(_row(state.kf_desc, k1), _row(state.kf_desc, k2)), BIG)
    best = masked.amin(dim=1)
    bj = masked.argmin(dim=1)
    cols = torch.arange(N, device=dev)
    second = torch.where(cols[None, :] == bj[:, None], BIG, masked).amin(dim=1)
    ok = (best <= max_dist) & (best.float() < ratio * second.float())
    ok = ok & (masked.argmin(dim=0)[bj] == cols)                   # mutual best

    mp2 = mp2_all[bj]
    pc1 = se3.apply(_row(state.kf_Tcw, k1), state.mp_pos[mp1.clamp(0, M - 1).long()])
    pc2 = se3.apply(_row(state.kf_Tcw, k2), state.mp_pos[mp2.clamp(0, M - 1).long()])
    ok = ok & (pc1[:, 2] > 0) & (pc2[:, 2] > 0)
    return (ok, bj.to(torch.int32), pc1, pc2, _row(state.kf_octave, k1), _row(state.kf_octave, k2)[bj],
            mp1, mp2)


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
    kf_cur,
    kf_cand,
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

    k_cur, k_cand = kf_index(kf_cur, dev), kf_index(kf_cand, dev)

    def side(k):
        mp = _row(state.kf_mp_idx, k)
        mpc = mp.clamp(0, M - 1).long()
        has = _row(state.kf_feat_valid, k) & (mp >= 0) & state.mp_valid[mpc]
        pc = se3.apply(_row(state.kf_Tcw, k), state.mp_pos[mpc])
        return has, pc, state.mp_min_dist[mpc], state.mp_max_dist[mpc]

    has1, pc1, minD1, maxD1 = side(k_cur)
    has2, pc2, minD2, maxD2 = side(k_cand)
    D = hamming_matrix(_row(state.kf_desc, k_cur), _row(state.kf_desc, k_cand))
    matched2 = mask_from_ids(torch.where(ok, bj, N), N)

    def one_direction(p_src_cam, S_to_other, src_free, src_minD, src_maxD, tgt_k, tgt_has_mp, dist):
        p_t = sim3.apply(S_to_other, p_src_cam)
        uv_t, in_front = project(cam, p_t)
        d = torch.linalg.vector_norm(p_t, dim=-1) / S_to_other.s
        dist_ok = (d >= 0.8 * src_minD) & (d <= 1.2 * src_maxD)
        lvl = _predict_level(src_maxD, d, scale_factor, n_levels)
        r = th * torch.pow(scale_factor, lvl.float())
        tgt_uv, tgt_oct = _row(state.kf_uv, tgt_k), _row(state.kf_octave, tgt_k)
        in_area = ((uv_t[:, None, 0] - tgt_uv[None, :, 0]).abs() <= r[:, None]) & (
            (uv_t[:, None, 1] - tgt_uv[None, :, 1]).abs() <= r[:, None])
        oct_ok = (tgt_oct[None, :] >= (lvl - 1)[:, None]) & (tgt_oct[None, :] <= (lvl + 1)[:, None])
        q_ok = src_free & in_front & _in_image(uv_t, width, height) & dist_ok
        return best_match(dist, in_area & oct_ok & tgt_has_mp[None, :] & q_ok[:, None], max_dist, ratio)

    fwd = one_direction(pc1, sim3.inverse(S12), has1 & ~ok, minD1, maxD1, k_cand, has2, D)
    bwd = one_direction(pc2, S12, has2 & ~matched2, minD2, maxD2, k_cur, has1, D.T)

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


def gather_match_pairs(state: MapState, kf_cur, kf_cand, ok, bj):
    """Camera-frame point pairs + octaves of a per-current-feature match set
    (the inputs of Sim3 RANSAC / OptimizeSim3): (ok, pc1, pc2, oct1, oct2,
    mp2)."""
    M = state.mp_capacity
    k_cur, k_cand = kf_index(kf_cur, bj.device), kf_index(kf_cand, bj.device)
    bjc = bj.clamp(0, state.kf_uv.shape[1] - 1).long()
    mp1 = _row(state.kf_mp_idx, k_cur)
    mp2 = _row(state.kf_mp_idx, k_cand)[bjc]
    pc1 = se3.apply(_row(state.kf_Tcw, k_cur), state.mp_pos[mp1.clamp(0, M - 1).long()])
    pc2 = se3.apply(_row(state.kf_Tcw, k_cand), state.mp_pos[mp2.clamp(0, M - 1).long()])
    ok = ok & (pc1[:, 2] > 0) & (pc2[:, 2] > 0) & (mp1 >= 0) & (mp2 >= 0)
    return ok, pc1, pc2, _row(state.kf_octave, k_cur), _row(state.kf_octave, k_cand)[bjc], mp2


def loop_group_snapshot(state: MapState, kf_cand, *, min_covis_weight: int, max_mps: int) -> LocalMap:
    """The candidate keyframe's covisibility group and every map point it
    observes (getConnectedKfs, LoopClosing.cc:381-401), compacted to
    ``max_mps`` slots by id (lowest first)."""
    K, M = state.kf_capacity, state.mp_capacity
    dev = state.covis.device
    k = kf_index(kf_cand, dev)
    kf_mask = (_row(state.covis, k) >= min_covis_weight) & state.kf_valid
    kf_mask = torch.where(torch.arange(K, device=dev) == k, _row(state.kf_valid, k), kf_mask)
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
    kf_cur,
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

    k = kf_index(kf_cur, matched_mp.device)
    cur_uv, cur_oct = _row(state.kf_uv, k), _row(state.kf_octave, k)
    in_area = ((uv_c[:, None, 0] - cur_uv[None, :, 0]).abs() <= r[:, None]) & (
        (uv_c[:, None, 1] - cur_uv[None, :, 1]).abs() <= r[:, None])
    oct_ok = (cur_oct[None, :] >= (lvl - 1)[:, None]) & (cur_oct[None, :] <= (lvl + 1)[:, None])
    q_ok = fresh & in_front & _in_image(uv_c, width, height) & dist_ok & angle_ok
    cand = (in_area & oct_ok & _row(state.kf_feat_valid, k)[None, :]
            & (matched_mp < 0)[None, :] & q_ok[:, None])
    m = best_match(hamming_matrix(group.desc, _row(state.kf_desc, k)), cand, max_dist, ratio)
    m = mutual_filter(m, N)
    matched_mp2 = set_drop(matched_mp, torch.where(m.found, m.idx, N), group.mp_ids)
    return matched_mp2, (matched_mp2 >= 0).to(torch.int32).sum().to(torch.int32)


def attach_matched_mps(state: MapState, kf_cur, matched_mp: torch.Tensor) -> MapState:
    """Fuse the Sim3-matched loop points into the current keyframe (reference
    correctLoop, LoopClosing.cc:497-513): empty feature slots adopt the loop
    point; occupied ones merge, the current keyframe's own point surviving
    (MapPoint::replace(pMpC, matched), :507)."""
    N, M = state.kf_uv.shape[1], state.mp_capacity
    dev = matched_mp.device
    k = kf_index(kf_cur, dev)
    cur_mp = _row(state.kf_mp_idx, k)
    valid_m = (matched_mp >= 0) & state.mp_valid[matched_mp.clamp(0, M - 1).long()]
    attach = valid_m & (cur_mp < 0) & _row(state.kf_feat_valid, k)
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
            state = fuse_one(state, cam, int(kf), group, width=width, height=height, scale_factor=scale_factor,
                             n_levels=n_levels)
    return state


def fuse_one(state: MapState, cam: CameraParams, kf, group: LocalMap, *, width: int, height: int,
             scale_factor: float, n_levels: int) -> MapState:
    """The loop group fused into one keyframe (a host int or an int [1]
    tensor): the body of ``fuse_group_into_kfs``."""
    return fuse_candidates_into_keyframe(
        state, kf, cam, group, width=width, height=height, scale_factor=scale_factor,
        n_levels=n_levels, th=4.0, max_dist=50, ratio=0.8, loop_priority=True,
    )


def reference_keyframe(state: MapState) -> torch.Tensor:
    """Each point's reference keyframe: its first observation whose keyframe
    is valid, i32 [M], −1 where no observer is left.  A culled keyframe's
    observations are cleared to −1 in place, so the first column can name
    none; ORB-SLAM2 hands a point's reference to another observer when its
    keyframe is erased (MapPoint::EraseObservation).  (JAX reads the first
    column, clipped: a point whose first observer was culled followed
    keyframe 0's correction.)"""
    K = state.kf_capacity
    obs = state.mp_obs_kf
    ok = (obs >= 0) & state.kf_valid[obs.clamp(0, K - 1).long()]
    first = obs.gather(1, ok.to(torch.int32).argmax(dim=1, keepdim=True))[:, 0]
    return torch.where(ok.any(dim=1), first, -1)


def correct_group(state: MapState, kf_cur, kf_cand, S12: sim3.Sim3, *,
                  min_covis_weight: int) -> Tuple[MapState, sim3.Sim3, torch.Tensor]:
    """Pose/point correction of the current covisibility group
    (LoopClosing.cc:458-513): the current keyframe's corrected pose is
    S12 ∘ T_cand_w, its group follows through the old relative poses, and
    each point whose reference keyframe (``reference_keyframe``) is a group
    member is remapped via S_new_wc ∘ S_old_cw.  The loop edge is recorded
    in the first free slot (dropped when none is free).

    Returns (state, S_nc, group_mask), ``S_nc`` the uncorrected Sim3 poses of
    every keyframe (the reference's NonCorrectedSim3)."""
    K = state.kf_capacity
    dev = state.kf_Tcw.device
    k_cur, k_cand = kf_index(kf_cur, dev), kf_index(kf_cand, dev)
    S_cw_corr = sim3.compose(S12, sim3.from_se3(_row(state.kf_Tcw, k_cand)))
    S_cw_old = sim3.from_se3(_row(state.kf_Tcw, k_cur))
    kf_ids = torch.arange(K, device=dev)
    group_mask = ((_row(state.covis, k_cur) >= min_covis_weight) & state.kf_valid) | (kf_ids == k_cur)

    S_all = sim3.from_se3(state.kf_Tcw)
    S_corr = sim3.compose(sim3.compose(S_all, sim3.inverse(S_cw_old)), S_cw_corr)
    kf_Tcw = torch.where(group_mask[:, None, None], sim3.to_se3(S_corr), state.kf_Tcw)

    ref = reference_keyframe(state)
    owner = ref.clamp(0, K - 1).long()
    owner_in_group = group_mask[owner] & (ref >= 0) & state.mp_valid
    p_new = sim3.apply(sim3.inverse(_take(S_corr, owner)), sim3.apply(_take(S_all, owner), state.mp_pos))
    mp_pos = torch.where(owner_in_group[:, None], p_new, state.mp_pos)

    E = state.loop_edges.shape[0]
    free = (state.loop_edges[:, 0] < 0).to(torch.int32)
    slot = torch.where(free.sum() > 0, torch.argmax(free), E).reshape(1)
    pair = torch.arange(2, dtype=torch.int32, device=dev)
    pair = torch.where(pair == 0, k_cur, k_cand).to(torch.int32)[None]
    loop_edges = set_drop(state.loop_edges, slot, pair)
    return state._replace(kf_Tcw=kf_Tcw, mp_pos=mp_pos, loop_edges=loop_edges), S_all, group_mask


def correct_front(state: MapState, kf_cur, kf_cand, S12: sim3.Sim3, matched_mp: torch.Tensor, *,
                  min_covis_weight: int) -> Tuple[MapState, sim3.Sim3, torch.Tensor, torch.Tensor]:
    """The correction up to the loop-group fuse: the connections before it
    (``covis > 0``), ``correct_group``, then ``attach_matched_mps`` (JAX's
    ``correct_group`` and ``_attach``).  Returns (state, S_nc, group_mask,
    pre_conn)."""
    pre_conn = state.covis > 0
    state, S_nc, group_mask = correct_group(state, kf_cur, kf_cand, S12, min_covis_weight=min_covis_weight)
    return attach_matched_mps(state, kf_cur, matched_mp), S_nc, group_mask, pre_conn


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


def essential_problem(
    state: MapState,
    kf_cur,
    kf_cand,
    S12: sim3.Sim3,
    S_nc: sim3.Sim3,
    group_mask: torch.Tensor,
    pre_conn: torch.Tensor,
    *,
    essential_weight: int,
    max_edges: int = 8192,
    max_new_conn: int = 256,
) -> PoseGraphProblem:
    """The essential graph as a pose-graph problem: the drift edges
    (spanning tree ∪ loop edges ∪ covis ≥ 100) measured from the
    uncorrected poses ``S_nc`` (Optimizer.cc:836-877), the new cross-loop
    connections the fuse created (group keyframe ↔ outside, unconnected
    before, weight ≥ 100 now) from the corrected ones (:804-833), the loop
    edge carrying S12.  The keyframe ids are host ints or int [1] device
    tensors.  Reads ``kf_Tcw``, ``kf_valid``, ``kf_parent``, ``covis`` and
    ``loop_edges``."""
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
    return PoseGraphProblem(
        S_cw=S_now, kf_valid=valid_kf, kf_fixed=fixed, edge_i=ei.clamp(min=0), edge_j=ej.clamp(min=0),
        edge_Sji=S_meas, edge_valid=(ei >= 0) & (ej >= 0), edge_weight=ew,
    )


def commit_essential(state: MapState, S_now: sim3.Sim3, S_opt: sim3.Sim3) -> MapState:
    """Poses commit as SE3, points via S_wc_new ∘ S_cw_old of their
    reference keyframe (``reference_keyframe``; Optimizer.cc:898-918).  Reads
    ``kf_valid``, ``kf_Tcw``, ``mp_obs_kf`` (a column of reference keyframes
    will do), ``mp_pos`` and ``mp_valid``."""
    K = state.kf_capacity
    ref = reference_keyframe(state)
    owner = ref.clamp(0, K - 1).long()
    p_new = sim3.apply(sim3.inverse(_take(S_opt, owner)), sim3.apply(_take(S_now, owner), state.mp_pos))
    return state._replace(
        kf_Tcw=torch.where(state.kf_valid[:, None, None], sim3.to_se3(S_opt), state.kf_Tcw),
        mp_pos=torch.where((state.mp_valid & (ref >= 0))[:, None], p_new, state.mp_pos),
    )


def optimize_essential(
    state: MapState,
    kf_cur,
    kf_cand,
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
    """Essential-graph optimization after correction + fuse:
    ``essential_problem``, solved by ``pose_graph_fn``, then
    ``commit_essential``."""
    prob = essential_problem(state, kf_cur, kf_cand, S12, S_nc, group_mask, pre_conn,
                             essential_weight=essential_weight, max_edges=max_edges,
                             max_new_conn=max_new_conn)
    return commit_essential(state, prob.S_cw, pose_graph_fn(prob))


# Gauss-Newton steps of the essential graph (Optimizer.cc:888: 20 iterations)
ESSENTIAL_ITERS = 20
# the map fields each part of the essential graph reads
_PROBLEM_FIELDS = ("kf_Tcw", "kf_valid", "kf_parent", "covis", "loop_edges")
_COMMIT_FIELDS = ("kf_Tcw", "kf_valid", "mp_obs_kf", "mp_pos", "mp_valid")


def _fields_of(state: MapState, names: tuple) -> tuple:
    """The named fields of ``state`` (``mp_obs_kf`` only its column of
    reference keyframes)."""
    return tuple(reference_keyframe(state)[:, None] if n == "mp_obs_kf" else getattr(state, n) for n in names)


def _partial_map(names: tuple, fields: tuple) -> MapState:
    """A MapState of the named fields, the others None."""
    full = dict.fromkeys(MapState._fields)
    full.update(zip(names, fields))
    return MapState(**full)


def _sharded_gn_step(prob: PoseGraphProblem, S: sim3.Sim3, *, mesh, shards=None) -> sim3.Sim3:
    """One edge-sharded GN step of a problem whose edges are padded to a
    multiple of the mesh size; without ``shards`` they are cut from ``prob``
    (views of it on a mesh of one device)."""
    return pose_graph._gn_step_pcg_sharded(prob, S, DAMPING, CG_ITERS, mesh,
                                           _shard_edges(prob, mesh) if shards is None else shards)


class EssentialGraph:
    """``optimize_essential`` as three ``StepGraph``s: the problem (edge
    collection and measurements), one GN step, replayed ``ESSENTIAL_ITERS``
    times, and the commit of poses and points.  Without a ``mesh`` the step
    is the single-process one (dense Cholesky up to ``dense_max_k`` keyframe
    slots, PCG above); with one, the problem pads its edges to a multiple of
    the mesh size and the step is the edge-sharded PCG (``optimize_pose_graph``
    over the mesh, JAX's ``_essential_mesh``), its edge shards cut inside
    the step as views of its input.  Over a mesh that is not
    ``capturable`` the sharded step runs eagerly between the two replayed
    parts, on shards cut once a call.  One GN step holds one step's buffers
    where the whole program would hold 20 steps', and captures in about a
    twentieth of the time.  Each part copies in only the map fields it
    reads.  ``kf_cur`` and ``kf_cand`` go in as int32 [1] device tensors
    (host ints are converted).  A part captures at its first call on the
    card and raises if the capture fails; ``capture=False`` runs the same
    static-buffer wrappers eagerly (the CPU).  ``traced(tracer)`` names the
    parts' graph ``essential``."""

    def __init__(self, *, essential_weight: int, dense_max_k: int = DENSE_MAX_K, mesh=None,
                 capture: bool = True):
        self.mesh = mesh

        def problem(fields, kf_cur, kf_cand, S12, S_nc, group_mask, pre_conn):
            prob = essential_problem(_partial_map(_PROBLEM_FIELDS, fields), kf_cur, kf_cand, S12, S_nc,
                                     group_mask, pre_conn, essential_weight=essential_weight)
            return prob if mesh is None else _pad_edges(prob, mesh.size)

        def commit(fields, S_now, S_opt):
            out = commit_essential(_partial_map(_COMMIT_FIELDS, fields), S_now, S_opt)
            return out.kf_Tcw, out.mp_pos

        step = (partial(gn_step, dense_max_k=dense_max_k) if mesh is None
                else partial(_sharded_gn_step, mesh=mesh))
        self.parts = (
            StepGraph(problem, capture=capture),
            StepGraph(step, capture=capture),
            StepGraph(commit, capture=capture),
        )

    def traced(self, tracer: Optional[Tracer]) -> "EssentialGraph":
        for p in self.parts:
            p.traced(tracer, "essential")
        return self

    @property
    def captures(self) -> int:
        return sum(p.captures for p in self.parts)

    @property
    def replays(self) -> int:
        return sum(p.replays for p in self.parts)

    def __call__(self, state: MapState, kf_cur, kf_cand, S12: sim3.Sim3, S_nc: sim3.Sim3,
                 group_mask: torch.Tensor, pre_conn: torch.Tensor) -> MapState:
        problem, step, commit = self.parts
        dev = state.kf_Tcw.device
        prob = problem(_fields_of(state, _PROBLEM_FIELDS), id_tensor(kf_cur, dev), id_tensor(kf_cand, dev),
                       S12, S_nc, group_mask, pre_conn)
        S = prob.S_cw
        if self.mesh is not None and not self.mesh.capturable:
            step = partial(_sharded_gn_step, mesh=self.mesh, shards=_shard_edges(prob, self.mesh))
        for _ in range(ESSENTIAL_ITERS):
            S = step(prob, S)
        kf_Tcw, mp_pos = commit(_fields_of(state, _COMMIT_FIELDS), prob.S_cw, S)
        return state._replace(kf_Tcw=kf_Tcw, mp_pos=mp_pos)


# the RANSAC hypotheses of the Sim3 stage (ransac_sim3's n_hyp)
SIM3_HYPOTHESES = 64
# the loop-group snapshot's point slots (JAX's _stage_c: max_mps=8192)
LOOP_GROUP_MPS = 8192


def bow_query(vocab: Vocabulary, desc: torch.Tensor, valid: torch.Tensor, max_words: int) -> BowVec:
    """The sparse BoW vector of one image's descriptors."""
    return sparse_bow(vocab, transform(vocab, desc, valid), max_words)


def candidate_rows(db: KeyFrameDB, state: MapState, query: BowVec, anchor_kf, *, n_words: int,
                   min_covis_weight: int) -> torch.Tensor:
    """Loop candidates of a BoW query anchored at ``anchor_kf``, with their
    covisibility rows: i32[5, 1 + K], the ids in column 0."""
    cand_ids, _ = find_loop_candidates(db, state, query, anchor_kf, n_candidates=5, n_words=n_words,
                                       min_covis_weight=min_covis_weight)
    rows = state.covis[cand_ids.clamp(0, state.kf_capacity - 1).long()]
    rows = torch.where((cand_ids >= 0)[:, None], rows, 0)
    return torch.cat([cand_ids[:, None], rows], dim=1)


def detect_program(state: MapState, db: KeyFrameDB, kf_id, *, vocab: Vocabulary, max_words: int,
                   min_covis_weight: int) -> torch.Tensor:
    """Registration of keyframe ``kf_id`` — its BoW row written into ``db``
    in place — and its candidate query (JAX's ``_add_and_detect_program``):
    i32[5, 1 + K]."""
    k = kf_index(kf_id, state.kf_desc.device)
    q = bow_query(vocab, _row(state.kf_desc, k), _row(state.kf_feat_valid, k), max_words)
    write_row_(db, k, q)
    return candidate_rows(db, state, q, k, n_words=vocab.n_words, min_covis_weight=min_covis_weight)


def frame_detect_program(state: MapState, db: KeyFrameDB, desc, valid, ref_kf, *, vocab: Vocabulary,
                         max_words: int, min_covis_weight: int) -> torch.Tensor:
    """Candidate query of a frame's descriptors anchored at ``ref_kf``, no
    registration (JAX's ``_frame_detect_program``): i32[5, 1 + K]."""
    return candidate_rows(db, state, bow_query(vocab, desc, valid, max_words), ref_kf, n_words=vocab.n_words,
                          min_covis_weight=min_covis_weight)


def pair_valid(state: MapState, kf_cur, kf_cand) -> torch.Tensor:
    """A keyframe culled while the deferred cascade spans idle frames
    invalidates the attempt (the reference's KeyFrame::SetBadFlag hooks)."""
    dev = state.kf_valid.device
    return (_row(state.kf_valid, kf_index(kf_cur, dev))
            & _row(state.kf_valid, kf_index(kf_cand, dev))).to(torch.int32)


def _inv_sigma2(octave, scale_factor: float):
    return torch.pow(1.0 / (scale_factor ** 2), octave.float())


def sim3_stage_a(state: MapState, cam: CameraParams, kf_cur, kf_cand, draw: torch.Tensor, *,
                 fix_scale: bool, chi2_th: float, scale_factor: float):
    """Descriptor match + Sim3 RANSAC (JAX's ``_stage_a``).  ``draw`` is the
    uniform draw f32[SIM3_HYPOTHESES, N] (``epnp.uniform_draw``) or integer
    minimal sets [H, 3].  Returns (S12, ok, bj, gates [n_matches,
    n_inliers, valid])."""
    ok, bj, pc1, pc2, oct1, oct2, _, _ = match_mappoint_features(state, kf_cur, kf_cand)
    sets, u = (None, draw) if draw.is_floating_point() else (draw, None)
    S12, _, n_in = ransac_sim3(
        pc1, pc2, ok, cam, _inv_sigma2(oct1, scale_factor), _inv_sigma2(oct2, scale_factor), sets=sets, u=u,
        n_hyp=SIM3_HYPOTHESES, fix_scale=fix_scale, chi2_th=chi2_th,
    )
    n_matches = ok.to(torch.int32).sum().to(torch.int32)
    return S12, ok, bj, torch.stack([n_matches, n_in.to(torch.int32), pair_valid(state, kf_cur, kf_cand)])


def sim3_stage_b(state: MapState, cam: CameraParams, kf_cur, kf_cand, S12: sim3.Sim3, ok, bj, *,
                 fix_scale: bool, chi2_th: float, width: int, height: int, scale_factor: float, n_levels: int):
    """searchBySim3 expansion + OptimizeSim3 (JAX's ``_stage_b``): (S12',
    matched_mp, gates [n_expanded, n_inliers, valid])."""
    ok, bj, n_exp = search_by_sim3_pair(state, cam, kf_cur, kf_cand, S12, ok, bj, th=7.5, width=width,
                                        height=height, scale_factor=scale_factor, n_levels=n_levels)
    ok2, pc1, pc2, oct1, oct2, mp2 = gather_match_pairs(state, kf_cur, kf_cand, ok, bj)
    S12b, inl2, n_in2 = optimize_sim3(
        S12, pc1, pc2, ok2, cam, _inv_sigma2(oct1, scale_factor), _inv_sigma2(oct2, scale_factor),
        fix_scale=fix_scale, chi2_th=chi2_th,
    )
    matched_mp = torch.where(ok2 & inl2, mp2, -1)
    return S12b, matched_mp, torch.stack([n_exp, n_in2.to(torch.int32), pair_valid(state, kf_cur, kf_cand)])


def sim3_stage_c(state: MapState, cam: CameraParams, kf_cur, kf_cand, S12: sim3.Sim3, matched_mp, *,
                 min_covis_weight: int, width: int, height: int, scale_factor: float, n_levels: int):
    """Loop-group projection (JAX's ``_stage_c``): (matched_mp', group,
    gates [n_total, valid])."""
    group = loop_group_snapshot(state, kf_cand, min_covis_weight=min_covis_weight, max_mps=LOOP_GROUP_MPS)
    k_cand = kf_index(kf_cand, state.kf_Tcw.device)
    S_cw = sim3.compose(S12, sim3.from_se3(_row(state.kf_Tcw, k_cand)))
    matched_mp, n_total = search_loop_group_projection(
        state, cam, kf_cur, S_cw, group, matched_mp, th=10.0, width=width, height=height,
        scale_factor=scale_factor, n_levels=n_levels)
    return matched_mp, group, torch.stack([n_total, pair_valid(state, kf_cur, kf_cand)])


class LoopGraphs:
    """JAX's remaining single-device loop-closing programs, one
    ``StepGraph`` each: ``detect`` (``_add_detect_prog``), ``frame_detect``
    (``_frame_detect_prog``), ``sim3_a`` / ``sim3_b`` / ``sim3_c``
    (``_sim3_a/b/c``), ``correct_front`` (``correct_group`` then
    ``_attach``) and ``fuse_one`` (one keyframe of ``_fuse_group``'s loop).

    Keyframe ids go in as int32 [1] tensors (host ints are filled in on the
    device), never as host ints a capture would bake in.  The map and the
    keyframe database are ``fixed``: a graph reads them at their addresses.
    ``detect`` writes the keyframe's BoW row into the database in place;
    ``correct_front`` and ``fuse_one`` write the map fields they change into
    the map storage (``donating``) and return only their small outputs.  A
    call whose map or database lies at other addresses (or has other
    shapes) drops that program's graph, and the next capture is made on
    the new storage.  The RANSAC draws nothing: stage A takes the uniform
    draw ``u`` (or integer minimal sets) as an input.  ``eager`` holds the
    programs themselves, with the map first.

    A program captures at its first call on the card and raises if the
    capture fails; ``capture=False`` runs the same static-buffer wrappers
    eagerly (the CPU).  ``capture_log`` names each capture in order,
    ``replays`` counts the replays and ``copied_bytes`` the bytes written
    into the map storage.  ``tracer`` names the steps' graph ``loop``."""

    def __init__(self, cfg: SLAMConfig, vocab: Vocabulary, *, capture: bool = True):
        o, c = cfg.orb, cfg.camera
        mw = cfg.mapping.min_covis_weight
        geom = dict(width=c.width, height=c.height, scale_factor=o.scale_factor, n_levels=o.n_levels)
        gates = dict(fix_scale=c.camera_type in (0, 1), chi2_th=cfg.ba.chi2_sim3)   # stereo / RGB-D: bFixScale
        bow = dict(vocab=vocab, max_words=cfg.bow.max_words_per_query, min_covis_weight=mw)
        self.eager = dict(
            detect=partial(detect_program, **bow),
            frame_detect=partial(frame_detect_program, **bow),
            sim3_a=partial(sim3_stage_a, scale_factor=o.scale_factor, **gates),
            sim3_b=partial(sim3_stage_b, **gates, **geom),
            sim3_c=partial(sim3_stage_c, min_covis_weight=mw, **geom),
            correct_front=partial(correct_front, min_covis_weight=mw),
            fuse_one=partial(fuse_one, **geom),
        )
        e, self._nbytes = self.eager, {}
        # the StepGraph programs: inputs first, then the fixed map (and database)
        self._programs = dict(
            detect=lambda kf, state, db: e["detect"](state, db, kf),
            frame_detect=lambda desc, valid, ref, state, db: e["frame_detect"](state, db, desc, valid, ref),
            sim3_a=lambda kc, kd, draw, cam, state: e["sim3_a"](state, cam, kc, kd, draw),
            sim3_b=lambda kc, kd, S12, ok, bj, cam, state: e["sim3_b"](state, cam, kc, kd, S12, ok, bj),
            sim3_c=lambda kc, kd, S12, mm, cam, state: e["sim3_c"](state, cam, kc, kd, S12, mm),
            correct_front=donating(lambda state, kc, kd, S12, mm: e["correct_front"](state, kc, kd, S12, mm),
                                   self._nbytes, "correct_front"),
            fuse_one=donating(lambda state, k, group, cam: (e["fuse_one"](state, cam, k, group),),
                              self._nbytes, "fuse_one"),
        )
        self.vocab = vocab
        self.capture = capture
        self.tracer: Optional[Tracer] = None
        self.capture_log: list = []
        self.replays = 0
        self.copied_bytes = 0
        self.clear()

    @property
    def captures(self) -> int:
        return len(self.capture_log)

    def clear(self) -> None:
        """Drop every graph (the map storage or the database was replaced)."""
        self._steps: Dict[str, tuple] = {}   # name -> (StepGraph, addresses of its fixed tensors)

    def _run(self, name: str, fixed: tuple, *inputs):
        where = tuple((t.data_ptr(), tuple(t.shape)) for t in tree_leaves(fixed))
        entry = self._steps.get(name)
        if entry is None or entry[1] != where:
            self._steps.pop(name, None)   # the old graph goes before the new capture
            entry = self._steps[name] = (StepGraph(self._programs[name], capture=self.capture)
                                         .traced(self.tracer, "loop"), where)
        step = entry[0]
        captures, replays = step.captures, step.replays
        out = step(*inputs, fixed=fixed)
        if step.captures > captures:
            self.capture_log.append(name)
        self.replays += step.replays - replays
        self.copied_bytes += self._nbytes.get(name, 0)
        return out

    def detect(self, state: MapState, db: KeyFrameDB, kf_id) -> torch.Tensor:
        return self._run("detect", (state, db), id_tensor(kf_id, state.kf_desc.device))

    def frame_detect(self, state: MapState, db: KeyFrameDB, desc, valid, ref_kf) -> torch.Tensor:
        return self._run("frame_detect", (state, db), desc, valid, id_tensor(ref_kf, state.kf_desc.device))

    def sim3_a(self, state: MapState, cam: CameraParams, kf_cur, kf_cand, draw: torch.Tensor):
        dev = state.kf_Tcw.device
        return self._run("sim3_a", (state,), id_tensor(kf_cur, dev), id_tensor(kf_cand, dev), draw, cam)

    def sim3_b(self, state: MapState, cam: CameraParams, kf_cur, kf_cand, S12: sim3.Sim3, ok, bj):
        dev = state.kf_Tcw.device
        return self._run("sim3_b", (state,), id_tensor(kf_cur, dev), id_tensor(kf_cand, dev), S12, ok, bj, cam)

    def sim3_c(self, state: MapState, cam: CameraParams, kf_cur, kf_cand, S12: sim3.Sim3, matched_mp):
        dev = state.kf_Tcw.device
        return self._run("sim3_c", (state,), id_tensor(kf_cur, dev), id_tensor(kf_cand, dev), S12, matched_mp,
                         cam)

    def correct_front(self, state: MapState, kf_cur, kf_cand, S12: sim3.Sim3, matched_mp):
        """``correct_front`` into the storage ``state``: returns (S_nc,
        group_mask, pre_conn)."""
        dev = state.kf_Tcw.device
        return self._run("correct_front", (state,), id_tensor(kf_cur, dev), id_tensor(kf_cand, dev), S12,
                         matched_mp)

    def fuse_one(self, state: MapState, cam: CameraParams, kf, group: LocalMap) -> None:
        """The loop group fused into keyframe ``kf``, into the storage ``state``."""
        self._run("fuse_one", (state,), id_tensor(kf, state.kf_Tcw.device), group, cam)


@contextlib.contextmanager
def _no_span(name: str):
    yield


class LoopCloser:
    """The loop closer: vocabulary, keyframe database, consistency chains
    and the deferred Sim3 cascade.  Detection, the three stages, the group
    correction and the fuse run through ``graphs`` (``LoopGraphs``, captured
    on the card, built at first use and dropped when the database grows),
    the essential graph through ``essential``.  ``span`` (name → context
    manager) wraps the stages that may read back, ``graph_span`` the
    captured ones; the system sets both to time them, and ``tracer`` to its
    own (the graphs' tracer, the ``read`` spans of host reads, the
    ``host_reads`` counter)."""

    def __init__(self, cfg: SLAMConfig, vocab: Vocabulary):
        self.cfg = cfg
        self.vocab = vocab
        self.device = vocab.device
        # the database storage: rows are written in place, so a captured
        # graph keeps reading and writing it at its addresses
        self.db = KeyFrameDB.empty(cfg.map.max_keyframes, cfg.bow.max_words_per_query, device=self.device)
        # consistency chains: (covisibility-group set, consecutive count)
        self.consistent_groups: List[Tuple[Set[int], int]] = []
        self.last_loop_kf = -1
        self.pending_sim3 = None   # the cascade in flight (sim3_begin / sim3_step)
        self.tracer = Tracer()
        # (kf_cur, kf_cand, stage, gate counts) of every stage read back
        self.gate_log: list = []
        self.span = _no_span
        self.graph_span = _no_span
        self.graphs: Optional[LoopGraphs] = None
        self._dropped_bytes = 0   # what dropped loop graphs wrote into the map storage
        # the essential graph of the last mesh asked for (None: unsharded),
        # built at its first use (on the card, captured by ``warmup``) and
        # dropped when the capacity grows
        self.essential: Optional[EssentialGraph] = None
        o, c = cfg.orb, cfg.camera
        self._geom = dict(width=c.width, height=c.height, scale_factor=o.scale_factor, n_levels=o.n_levels)

    def grow(self, n_keyframes: int) -> None:
        """Re-pad the sparse BoW rows when the map's keyframe capacity grows
        (SLAM._grow); row ids are stable, so existing entries carry over.
        The loop graphs and the essential graph of the old capacity are
        dropped."""
        dK = n_keyframes - self.db.word_ids.shape[0]
        if dK <= 0:
            return
        self._dropped_bytes = self.copied_bytes
        self.essential = self.graphs = None
        more = KeyFrameDB.empty(dK, self.db.max_words, device=self.db.word_ids.device)
        self.db = KeyFrameDB(
            word_ids=torch.cat([self.db.word_ids, more.word_ids]),
            weights=torch.cat([self.db.weights, more.weights]),
        )

    @property
    def copied_bytes(self) -> int:
        """Bytes the loop graphs wrote into the map storage."""
        return self._dropped_bytes + (self.graphs.copied_bytes if self.graphs is not None else 0)

    @property
    def host_reads(self) -> int:
        """Waits for a copied detection or gate: host reads that the sync
        debug mode does not report."""
        return self.tracer.counts.get("host_reads", 0)

    def loop_graphs(self) -> LoopGraphs:
        """The loop graphs, built at their first use (captured on the card)."""
        if self.graphs is None:
            self.graphs = LoopGraphs(self.cfg, self.vocab, capture=self.device.type == "cuda")
            self.graphs.tracer = self.tracer
        return self.graphs

    def add_keyframe_to_db(self, state: MapState, kf_id: int) -> None:
        """Register keyframe ``kf_id`` in the database, in place."""
        k = kf_index(kf_id, self.device)
        write_row_(self.db, k, bow_query(self.vocab, _row(state.kf_desc, k), _row(state.kf_feat_valid, k),
                                         self.db.max_words))

    def _read(self, x) -> np.ndarray:
        if isinstance(x, HostCopy) and x.on_device:
            self.tracer.count("host_reads")
        with self.tracer.span("read"):
            return _fetch(x)

    # ------------------------------------------------------------------
    def add_and_detect(self, state: MapState, kf_id: int) -> torch.Tensor:
        """Database registration + candidate query of keyframe ``kf_id``."""
        return self.loop_graphs().detect(state, self.db, kf_id)

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
        return HostCopy(self.loop_graphs().frame_detect(state, self.db, desc, valid, ref_kf))

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
    def stage_a(self, state: MapState, cam: CameraParams, kf_cur, kf_cand,
                generator: Optional[torch.Generator] = None, *, sets=None):
        """Descriptor match + Sim3 RANSAC (``sim3_stage_a``) through the
        graph, on the uniform draw taken from ``generator`` first, or on
        ``sets``: (S12, ok, bj, gates [n_matches, n_inliers, valid])."""
        dev = state.kf_uv.device
        if sets is not None:
            draw = torch.as_tensor(sets, device=dev)
        elif generator is not None:
            draw = uniform_draw((), state.kf_uv.shape[1], generator, SIM3_HYPOTHESES, device=dev)
        else:
            raise ValueError("stage_a needs a generator or explicit sets")
        return self.loop_graphs().sim3_a(state, cam, kf_cur, kf_cand, draw)

    def stage_b(self, state: MapState, cam: CameraParams, kf_cur, kf_cand, S12, ok, bj):
        """searchBySim3 expansion + OptimizeSim3 (``sim3_stage_b``) through
        the graph: (S12', matched_mp, gates [n_expanded, n_inliers, valid])."""
        return self.loop_graphs().sim3_b(state, cam, kf_cur, kf_cand, S12, ok, bj)

    def stage_c(self, state: MapState, cam: CameraParams, kf_cur, kf_cand, S12, matched_mp):
        """Loop-group projection (``sim3_stage_c``) through the graph:
        (matched_mp', group, gates [n_total, valid])."""
        return self.loop_graphs().sim3_c(state, cam, kf_cur, kf_cand, S12, matched_mp)

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
        with self.graph_span("sim3_a"):
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
        rejected = f"loop.rejected.sim3_{p['stage']}"
        if p["stage"] == "a":
            n_matches, n_in, valid = g
            if not valid or n_matches < lc.min_bow_matches or n_in < lc.min_sim3_inliers:
                self.pending_sim3 = None
                self.tracer.count(rejected)
                return None
            with self.graph_span("sim3_b"):
                S12, matched_mp, gates = self.stage_b(state, cam, kf_cur, kf_cand, p["S12"], p["ok"], p["bj"])
            self.pending_sim3 = dict(stage="b", kf_cur=kf_cur, kf_cand=kf_cand, S12=S12,
                                     matched_mp=matched_mp, gates=HostCopy(gates))
            return None
        if p["stage"] == "b":
            n_exp, n_in2, valid = g
            if not valid or n_exp < lc.min_expanded_matches or n_in2 < lc.min_sim3_opt_inliers:
                self.pending_sim3 = None
                self.tracer.count(rejected)
                return None
            with self.graph_span("sim3_c"):
                matched_mp, group, gates = self.stage_c(state, cam, kf_cur, kf_cand, p["S12"],
                                                        p["matched_mp"])
            self.pending_sim3 = dict(stage="c", kf_cur=kf_cur, kf_cand=kf_cand, S12=p["S12"],
                                     matched_mp=matched_mp, group=group, gates=HostCopy(gates))
            return None
        n_total, valid = g
        self.pending_sim3 = None
        if not valid or n_total < lc.min_group_proj_matches:
            self.tracer.count(rejected)
            return None
        return kf_cur, kf_cand, p["S12"], p["matched_mp"], p["group"]

    # ------------------------------------------------------------------
    def warm_graphs(self, state: MapState, cam: CameraParams) -> None:
        """Run every loop graph once, on keyframe 0 against itself, and put
        the map and the database back as they were: on the card each graph
        is captured here, on ``state``'s storage and this database, not at
        the next keyframe or closure."""
        g = self.loop_graphs()
        dev = state.kf_Tcw.device
        saved = [t.clone() for t in (*state, *self.db)]
        k0 = kf_index(0, dev)
        g.detect(state, self.db, 0)
        g.frame_detect(state, self.db, _row(state.kf_desc, k0), _row(state.kf_feat_valid, k0), 0)
        u = uniform_draw((), state.kf_uv.shape[1], self._generator(0), SIM3_HYPOTHESES, device=dev)
        S12, ok, bj, _ = g.sim3_a(state, cam, 0, 0, u)
        S12, matched_mp, _ = g.sim3_b(state, cam, 0, 0, S12, ok, bj)
        matched_mp, group, _ = g.sim3_c(state, cam, 0, 0, S12, matched_mp)
        g.correct_front(state, 0, 0, sim3.identity(device=dev), matched_mp)
        g.fuse_one(state, cam, 0, group)
        torch._foreach_copy_([*state, *self.db], saved)

    def warmup(self, state: MapState, cam: CameraParams, mesh=None) -> None:
        """Run detection, the three stages, the correction's graphs
        (``warm_graphs``) and the essential graph (over ``mesh`` when given)
        once on keyframe 0 against itself and discard the results, so that
        the first real attempt pays no one-off capture, library load or
        allocation mid-run.  The map is left as it was; keyframe 0 is
        registered in the database, as the JAX warm-up does."""
        self.warm_graphs(state, cam)
        self.add_and_detect(state, 0)
        self.warm_essential(state, mesh)

    def _essential_graph(self, device: torch.device, mesh=None) -> EssentialGraph:
        if self.essential is None or self.essential.mesh != mesh:
            if mesh is not None and mesh.axis != self.cfg.dist.mesh_axis:
                raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {self.cfg.dist.mesh_axis!r}")
            self.essential = EssentialGraph(essential_weight=self.cfg.loop.essential_graph_weight,
                                            mesh=mesh, capture=device.type == "cuda").traced(self.tracer)
        return self.essential

    def warm_essential(self, state: MapState, mesh=None) -> None:
        """Run the essential graph (over ``mesh`` when given) once on
        ``state`` (keyframe 0 against itself, nothing moved) and discard the
        result: on the card the graphs of ``state``'s capacity are captured
        here, not at the next closure."""
        K, dev = state.kf_capacity, state.kf_Tcw.device
        zero = torch.zeros((1,), dtype=torch.int32, device=dev)
        self._essential_graph(dev, mesh)(state, zero, zero, sim3.identity(device=dev),
                                         sim3.from_se3(state.kf_Tcw),
                                         torch.zeros((K,), dtype=torch.bool, device=dev), state.covis > 0)

    def _essential_mesh(self, state, kf_cur, kf_cand, S12, S_nc, group_mask, pre_conn, *, mesh) -> MapState:
        """The essential graph by the edge-sharded PCG over ``mesh``, eagerly:
        the reference the mesh route of ``EssentialGraph`` is held to."""
        return optimize_essential(
            state, kf_cur, kf_cand, S12, S_nc, group_mask, pre_conn,
            essential_weight=self.cfg.loop.essential_graph_weight,
            pose_graph_fn=partial(optimize_pose_graph, iters=ESSENTIAL_ITERS, mesh=mesh,
                                  mesh_axis=self.cfg.dist.mesh_axis),
        )

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
        in_place: bool = False,
    ) -> MapState:
        """Loop correction (LoopClosing.cc:432-541): group pose/point
        propagation and the matched-point fuse (``correct_front``), one read
        of the current keyframe's covisibility row for its top-16 covisible
        neighbours (numpy's argsort, as JAX picks them), the loop-group fuse
        into each (``fuse_one``), essential-graph optimization, and the
        synchronous global BA when ``run_gba``.  The front and the fuses run
        through the loop graphs and write into ``state`` itself with
        ``in_place`` (the system's map storage), else into a copy of it.
        The essential graph runs as ``EssentialGraph`` (captured on the
        card), over ``mesh`` when given; the global BA then takes the
        sharded solve."""
        mw = self.cfg.mapping.min_covis_weight
        g = self.loop_graphs()
        if not in_place:
            state = MapState(*(t.clone() for t in state))
        with self.graph_span("correct_front"):
            S_nc, group_mask, pre_conn = g.correct_front(state, kf_cur, kf_cand, S12, matched_mp)
        with self.span("covis_read"), self.tracer.span("read"):
            w = state.covis[kf_cur].cpu().numpy()
        ids = np.argsort(-w)[:16]
        ids = ids[w[ids] >= mw]
        with self.graph_span("fuse"):
            for kf in ids.tolist():
                g.fuse_one(state, cam, kf, group)
        with self.span("optimize_essential"):
            dev = state.kf_Tcw.device
            state = self._essential_graph(dev, mesh)(state, id_tensor(kf_cur, dev), id_tensor(kf_cand, dev),
                                                     S12, S_nc, group_mask, pre_conn)
        if run_gba:
            state = global_ba(state, cam, scale_factor=self.cfg.orb.scale_factor,
                              phase_iters=tuple(self.cfg.loop.global_ba_phase_iters),
                              pcg_iters=self.cfg.ba.pcg_iters, mesh=mesh, axis=self.cfg.dist.mesh_axis)
        self.last_loop_kf = kf_cur
        self.consistent_groups = []
        return state
