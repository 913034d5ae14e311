"""The SLAM system: stereo or RGB-D tracking, local mapping with local BA,
loop closing with the essential graph and a background global BA, and
relocalization in a saved map.

Port of ``orb_slam2_ros2_tpu/pipeline/system.py`` (reference src/System.cc,
src/Tracking.cc, src/LocalMapping.cc, src/LoopClosing.cc).  Frame 0
initializes the map from stereo depth (one keyframe); every later frame runs
ONE frame program —
frontend → motion-model match + pose-only LM → local-map projection match +
a second LM → counter bumps, stats and the frame-centred local-map refresh —
and the host reads ONE stats vector back.  Outside localization mode
(``tracking.only_tracking=False``) the host then decides on a keyframe; a
keyframe runs the mapping front program (insert → map-point cull →
triangulate → two-way fuse → snapshot), and the deferred tail program
(local BA → keyframe cull → snapshot) runs on the next idle frame, or at
once with ``mapping.synchronous``.  None of the three programs synchronises
with the host (no ``.item()``, boolean-mask indexing or host copies), which
``SLAM.frame_sync_debug_mode`` can enforce.  On a CUDA device the frame
program is replayed as a captured CUDA graph (``frame_graph.FrameGraphs``,
the counterpart of the JAX system's jitted frame program), and so are the
keyframe programs (``frame_graph.KeyframeGraphs``); the map lives in storage
that outlasts the programs, so a keyframe needs no new capture.

With ``tracking.pipelined`` the host dispatches frame N+1 before it resolves
frame N, so the fetch and the host's decisions overlap the device's work
(``_track_pipelined``); ``track()`` then returns the previous frame's pose.

Loop closing (``enable_loop_closing=True``, the default) registers every
keyframe in the place-recognition database when its tail runs (or its BA is
aborted) and dispatches the candidate query without a host read; idle frames
then, in this order, advance the Sim3 cascade one stage, resolve one pending
detection through the consistency chains, or run one chunk of the background
global BA; a verified loop is corrected at once (group propagation, fuses,
essential graph), the GBA snapshot taken, and its commit re-anchors the
tracker.  The dispatch and the GBA chunks read nothing back; the resolve, the
stage gates, the correction and the commit do.  The GBA chunk and commit run
as ``global_ba.GBAGraphs`` (captured CUDA graphs on the card): the commit
under any mesh, the chunk unsharded or over a ``capturable`` mesh.

Relocalization (a LOST frame, or the first frame on a loaded map) queries the
keyframe database — BoW candidates → descriptor match → EPnP RANSAC →
pose-only LM → two projection augmentation rounds, ``reloc_all_candidates``
— and costs one fetch; query and cascade are one program
(``frame_graph.RelocGraph``, a CUDA graph on the card).  Without a database
(localization mode without ``load()`` of a map saved with its vocabulary) a
LOST frame returns
``(None, {"reloc": "no_vocab"})`` as the JAX system does.  ``save`` /
``load`` handle the npz map format and the reference's protobuf and txt
formats.

Multi-device operation (``cfg.dist``): with ``n_devices > 1`` the essential
graph and the global BA shard over a device mesh (``parallel/mesh.py``);
with ``tracker_mapper_split`` the tracker device runs the frontend and the
tracking step against a published view of the map (``mp_pos``, ``mp_valid``
and the local map), and the map device owns the map and runs the per-frame
bookkeeping, the keyframe programs, loop closing and the GBA (the
reference's tracking / mapping thread split, System.cc:119-129, as a device
split).  The view is refreshed after each mapping event; the split turns
the pipelined loop off.  On the card a mesh of one process whose slots share
one device (``Mesh.capturable``) replays the sharded GBA chunk and the
essential graph's sharded GN step as CUDA graphs; over a mesh of several
processes or devices they run eagerly between captured unsharded parts.
The split's bookkeeping replays a graph on a CUDA map device.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
import weakref
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..bow import vocabulary as bow_vocabulary
from ..bow.keyframe_db import KeyFrameDB, find_reloc_candidates, rebuild, sparse_bow
from ..config import SLAMConfig
from ..errors import FeatureLessError, FileNotOpenError, ImageSizeError
from ..features.extractor import make_rgbd_frontend, make_stereo_frontend
from ..features.frame import FrameFeatures, StereoFrame
from ..geometry import se3
from ..geometry.camera import CameraParams, project, unproject
from ..io.persistence import load_map, save_map
from ..io.proto_map import load_proto_map, save_proto_map
from ..io.txt_map import load_txt_map, save_txt_map
from ..mapstate.local_map import (
    LocalMap,
    bump_tracking_counters,
    local_map_snapshot,
    local_map_snapshot_frame,
)
from ..mapstate.map_state import MapState, copy_into, empty_map, grow_map, insert_keyframe, kf_index
from ..parallel.mesh import ba_mesh, default_devices, local_devices
from ..mapstate.mapping import (
    cull_keyframes,
    cull_mappoints,
    fuse_into_keyframe,
    fuse_keyframe_into_neighbors,
    triangulate_new_points,
)
from ..matching import matcher
from ..ops.hamming import hamming_matrix
from ..solvers.epnp import N_HYP, ransac_pnp, uniform_draw
from ..solvers.global_ba import GBAGraphs, global_ba, start_global_ba
from ..solvers.local_ba import local_ba
from ..solvers.pose_opt import PoseObs, optimize_pose
from ..utils import count_into, mask_from_ids, mask_from_ids_rows, set_drop, set_drop_rows
from .frame_graph import FrameGraphs, KeyframeGraphs, PinnedRing, RelocGraph, tree_map
from .loop_closing import HostCopy, LoopCloser
from .trace import Tracer
from .tracking import TrackState


# relocalization candidates a LOST frame's cascade tries (findRelocKfs)
RELOC_CANDIDATES = 5


class SlamFrame(NamedTuple):
    """Per-frame tracking result kept as 'last frame' state."""

    frame: StereoFrame
    Tcw: torch.Tensor
    mp_ids: torch.Tensor   # i32[N] map point per feature (−1 = none)


class _Inflight(NamedTuple):
    """A frame the pipelined loop dispatched and has not resolved yet."""

    fid: int
    state: SlamFrame
    velocity: torch.Tensor
    host: HostCopy          # its stats vector on the way to the host
    ref_kf: int             # the reference keyframe whose pose rode the vector
    imgs: tuple             # (left, right) on the device, for a re-dispatch
    local_in: LocalMap      # the local map it was dispatched with
    last_in: SlamFrame      # the last frame it was dispatched from


def _rigid_inv(T: np.ndarray) -> np.ndarray:
    """Host-side SE(3) inverse (transpose form)."""
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = T[:3, :3].T
    out[:3, 3] = -T[:3, :3].T @ T[:3, 3]
    return out


def _indexed(device) -> torch.device:
    """A CUDA device with its index: a tensor on the card names it (cuda:0),
    so an image already there compares equal to the SLAM's device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _join_stats(hv0: torch.Tensor, hv1: torch.Tensor) -> torch.Tensor:
    """The frame's stats vector from the tracker's [7 counts, Tcw(16)] and
    the map's [best_ref, next_mp, n_ref, Tcw_refkf(16)]: [STAT_KEYS...,
    Tcw.flat(16), Tcw_refkf.flat(16)]."""
    n_stat = hv0.shape[0] - 16
    return torch.cat([hv0[:n_stat], hv1[:3], hv0[n_stat:], hv1[3:]])


def _octave_inv_sigma2(octave: torch.Tensor, scale_factor: float) -> torch.Tensor:
    return torch.pow(1.0 / (scale_factor * scale_factor), octave.float())


def _select(c: torch.Tensor, a: matcher.MatchResult, b: matcher.MatchResult) -> matcher.MatchResult:
    return matcher.MatchResult(idx=torch.where(c, a.idx, b.idx), dist=torch.where(c, a.dist, b.dist))


# the truncation points of slam_track_step, in order (JAX system.py:169-256)
STOP_AFTER = ("match1", "opt1", "match2", "vis", "opt2", "full")


def slam_track_step(
    cam: CameraParams,
    cur: StereoFrame,
    last: SlamFrame,
    velocity: torch.Tensor,
    local: LocalMap,
    mp_pos: torch.Tensor,
    mp_valid: torch.Tensor,
    *,
    radius: float,
    proj_th: float,
    scale_factor: float,
    n_levels: int,
    baseline: float,
    width: int,
    height: int,
    max_dist: int,
    ratio_track: float,
    chi2_mono: float,
    chi2_stereo: float,
    depth_threshold: float,
    min_motion_matches: int,
    pose_rounds: int = 4,
    pose_iters: int = 6,
    stop_after: str = "full",
):
    """One full tracking step (motion model + local map), mirroring
    Tracking::trackMotionModel + trackLocalMap (reference Tracking.cc:381-406,
    :641-675).  Returns (new frame state, velocity, host stats vector,
    visible mask, found mask) — the masks aligned with ``local``.

    ``stop_after`` truncates the step for a stage profile
    (``tools/profile_frame.py``), returning what the JAX step returns there:
    ``"match1"`` the motion-model match, ``"opt1"`` (Tcw1, n_in1, n_m1),
    ``"match2"`` the projection match, ``"vis"`` the visible mask, ``"opt2"``
    (Tcw2, n_tracked); ``"full"`` is the whole step."""
    if stop_after not in STOP_AFTER:
        raise ValueError(f"stop_after must be one of {STOP_AFTER}, got {stop_after!r}")
    N = cur.feats.capacity
    M = mp_pos.shape[0]
    dev = velocity.device
    Tcw_pred = velocity @ last.Tcw

    # ---------- stage 1: motion-model match against the last frame --------
    last_has_mp = last.mp_ids >= 0
    # temp 3D for last-frame features without map points: CLOSE stereo depth
    # plus the nearest-100 floor (original ORB-SLAM2 UpdateLastFrame)
    ldep = last.frame.depth
    lseed = last.frame.feats.valid & (ldep > 0)
    lclose = lseed & (ldep < depth_threshold)
    lneed = torch.clamp(100 - lclose.to(torch.int32).sum(), min=0)
    lfar_d = torch.where(lseed & ~lclose, ldep, float("inf"))
    lrank = torch.argsort(torch.argsort(lfar_d, stable=True), stable=True)
    last_depth_ok = lclose | (torch.isfinite(lfar_d) & (lrank < lneed))
    pc_last = unproject(cam, last.frame.feats.uv, torch.where(last_depth_ok, ldep, 1.0))
    pw_temp = se3.apply(se3.inverse(last.Tcw), pc_last)
    pw_last = torch.where(last_has_mp[:, None], mp_pos[last.mp_ids.clamp(0, M - 1).long()], pw_temp)
    prev_usable = last_has_mp | last_depth_ok

    twc_cur = se3.t_of(se3.inverse(Tcw_pred))
    z_forward = se3.apply(last.Tcw, twc_cur[None])[0, 2]

    prev_feats = last.frame.feats
    lo, hi = matcher.forward_backward_octaves(prev_feats.octave, z_forward, baseline, n_levels)
    dist1 = hamming_matrix(prev_feats.desc, cur.feats.desc)
    # search around each point's projection through the motion model
    # (ORBMatcher::SearchByProjection(Frame&, Frame&, th))
    uv_pred, in_front = project(cam, se3.apply(Tcw_pred, pw_last))

    def _motion_match(r: float):
        cand = matcher.area_candidates(uv_pred, prev_feats.octave, cur.feats, r, lo, hi, scale_factor)
        cand = cand & (prev_feats.valid & prev_usable & in_front)[:, None]
        m = matcher.best_match(dist1, cand, max_dist, ratio_track)
        keep = matcher.rotation_consistency(
            prev_feats.angle, cur.feats.angle[m.idx.clamp(min=0).long()], m.found
        )
        m = matcher.MatchResult(idx=torch.where(keep, m.idx, -1), dist=m.dist)
        return matcher.mutual_filter(m, N)

    # the r → 2r retry (Tracking.cc:388-391): both radii are computed and the
    # result selected on the device, so no host decision is needed
    m1_r = _motion_match(radius)
    m1_2r = _motion_match(radius * 2)
    m1 = _select(m1_r.found.to(torch.int32).sum() < min_motion_matches, m1_2r, m1_r)
    if stop_after == "match1":
        return m1

    c1 = m1.idx.clamp(min=0).long()
    obs1 = PoseObs(
        pw=pw_last,
        uv=cur.feats.uv[c1],
        right_u=cur.right_u[c1],
        inv_sigma2=_octave_inv_sigma2(cur.feats.octave[c1], scale_factor),
        is_stereo=cur.right_u[c1] > 0,
        valid=m1.found,
    )
    # stage 1 runs half the χ²-gating rounds: its pose only seeds stage 2
    Tcw1, _, n_in1 = optimize_pose(
        cam, Tcw_pred, obs1, chi2_mono=chi2_mono, chi2_stereo=chi2_stereo,
        rounds=max(pose_rounds // 2, 1), iters_per_round=pose_iters,
    )
    n_m1 = m1.found.to(torch.int32).sum()
    if stop_after == "opt1":
        return Tcw1, n_in1, n_m1

    # per-current-feature map-point assignment inherited from the last frame
    src_mp = torch.where(m1.found & last_has_mp, last.mp_ids, -1)
    cur_mp = torch.full((N,), -1, dtype=torch.int32, device=dev)
    cur_mp = set_drop(cur_mp, torch.where(src_mp >= 0, m1.idx, N), src_mp)

    # ---------- stage 2: local-map projection matching --------------------
    vis = matcher.mappoint_visibility(
        cam, Tcw1, local.pos, local.normal, local.min_dist, local.max_dist,
        width=width, height=height, scale_factor=scale_factor, n_levels=n_levels,
    )
    m2 = matcher.search_mappoints_projection(
        cam, Tcw1,
        local.pos, local.normal, local.min_dist, local.max_dist, local.desc,
        local.valid & mp_valid[local.mp_ids.clamp(0, M - 1).long()],
        cur.feats, cur_mp >= 0,
        th=proj_th, width=width, height=height, scale_factor=scale_factor,
        n_levels=n_levels, max_dist=max_dist, ratio=0.8,
        precomputed_vis=vis,
    )
    if stop_after == "match2":
        return m2
    c2 = m2.idx.clamp(0, N - 1).long()
    cur_mp = set_drop(cur_mp, torch.where(m2.found, m2.idx, N), local.mp_ids)

    visible = vis[1] & local.valid
    if stop_after == "vis":
        return visible
    # local-map match count (trackLocalMap's nMatches ≥ 30 gate input)
    n_localmap = (cur_mp >= 0).to(torch.int32).sum()

    # ---------- stage 3: pose refinement on the full map-point set --------
    has_mp = cur_mp >= 0
    mp_c = cur_mp.clamp(0, M - 1).long()
    # temp-point motion matches stay in the refinement as anchors
    temp_tgt = torch.where(m1.found & ~(src_mp >= 0), m1.idx, N)
    temp_obs_pw = set_drop(torch.zeros((N, 3), dtype=torch.float32, device=dev), temp_tgt, pw_last)
    temp_valid = set_drop(torch.zeros(N, dtype=torch.bool, device=dev), temp_tgt, True)
    pw_all = torch.where(has_mp[:, None], mp_pos[mp_c], temp_obs_pw)
    obs2 = PoseObs(
        pw=pw_all,
        uv=cur.feats.uv,
        right_u=cur.right_u,
        inv_sigma2=_octave_inv_sigma2(cur.feats.octave, scale_factor),
        is_stereo=cur.right_u > 0,
        valid=(has_mp | temp_valid) & cur.feats.valid,
    )
    Tcw2, inlier2, n_in2 = optimize_pose(
        cam, Tcw1, obs2, chi2_mono=chi2_mono, chi2_stereo=chi2_stereo,
        rounds=pose_rounds, iters_per_round=pose_iters,
    )
    n_tracked = (inlier2 & has_mp).to(torch.int32).sum()
    if stop_after == "opt2":
        return Tcw2, n_tracked

    # drop outlier map-point assignments (reference Optimizer.cc:188-200)
    cur_mp = torch.where(inlier2 | ~has_mp, cur_mp, -1)

    # found mask aligned with `local`: matched here AND inlier, or inherited
    found_local = m2.found & inlier2[c2]
    matched_mask = mask_from_ids(torch.where((cur_mp >= 0) & inlier2, cur_mp, M), M)
    found_local = found_local | matched_mask[local.mp_ids.clamp(0, M - 1).long()]

    # keyframe-decision scalars (Tracking.cc:721-804)
    close = cur.feats.valid & (cur.depth > 0) & (cur.depth < depth_threshold)
    n_close_tracked = (close & has_mp & inlier2).to(torch.int32).sum()
    n_close_untracked = (close & ~has_mp).to(torch.int32).sum()

    velocity_new = Tcw2 @ se3.inverse(last.Tcw)
    new_state = SlamFrame(frame=cur, Tcw=Tcw2, mp_ids=cur_mp)
    # stats and pose in one f32 vector: ONE device→host transfer per frame
    # ([stats..., Tcw.flat(16)]; counts < 2^24 are exact in f32)
    counts = (n_m1, n_in1, n_localmap, n_tracked, n_in2, n_close_tracked, n_close_untracked)
    host_vec = torch.cat([torch.stack([x.float() for x in counts]), Tcw2.reshape(-1)])
    return new_state, velocity_new, host_vec, visible, found_local


STAT_KEYS = (
    "n_motion_matches", "n_motion_inliers", "n_localmap_matches",
    "n_tracked", "n_inliers", "n_close_tracked", "n_close_untracked",
    "best_ref_kf", "next_mp", "n_ref_matches",
)


def _best_ref_kf(state: MapState, mp_ids: torch.Tensor) -> torch.Tensor:
    """Keyframe sharing the most currently-tracked map points (the
    only-tracking reference-KF reselection, reference Map.cc:176-197)."""
    M, K = state.mp_capacity, state.kf_capacity
    obs_kf = state.mp_obs_kf[mp_ids.clamp(0, M - 1).long()]            # [N, O]
    src = torch.where((mp_ids >= 0)[:, None] & (obs_kf >= 0), obs_kf, K)
    counts = torch.where(state.kf_valid, count_into(src, K), -1)
    return torch.argmax(counts).float()


def _bookkeep_stats(mapstate: MapState, mp_ids: torch.Tensor, ref_kf,
                    min_obs_bar: int = 3) -> torch.Tensor:
    """Map-side per-frame stats vector [19]: best_ref, next_mp, nRefMatches
    (reference-KF points with ≥ nMinObs observations, 2 while the map holds
    ≤ 2 keyframes), ref-KF pose (flat 16).  ``ref_kf`` is a device int
    tensor of one element (as the JAX system passes a device int32) or a
    host int; it is clamped and gathered with on the device, so a captured
    frame graph reads the reference keyframe of each replay."""
    best_ref = _best_ref_kf(mapstate, mp_ids)
    rk = kf_index(ref_kf, mp_ids.device).clamp(0, mapstate.kf_capacity - 1)
    rmp = mapstate.kf_mp_idx[rk][0]
    rmpc = rmp.clamp(0, mapstate.mp_capacity - 1).long()
    nkfs = mapstate.kf_valid.to(torch.int32).sum()
    min_obs = torch.where(nkfs <= 2, 2, min_obs_bar)
    n_ref = (
        mapstate.kf_feat_valid[rk][0] & (rmp >= 0) & mapstate.mp_valid[rmpc]
        & (mapstate.mp_n_obs[rmpc] >= min_obs)
    ).to(torch.int32).sum().float()
    return torch.cat([
        torch.stack([best_ref, mapstate.next_mp.float(), n_ref]),
        mapstate.kf_Tcw[rk][0].reshape(-1),
    ])


def reloc_project_augment(
    state: MapState,
    cand,
    cam: CameraParams,
    frame: StereoFrame,
    Tcw: torch.Tensor,
    cur_mp: torch.Tensor,
    *,
    th: float,
    width: int,
    height: int,
    scale_factor: float,
    n_levels: int,
    max_dist: int,
    ratio: float,
):
    """Relocalization match augmentation — ``searchByProjection(curFrame,
    candidateKF, th)`` inside addMatchByProject (Tracking.cc:612-629):
    project the candidate keyframe's map points into the current frame
    around the estimated pose and attach matches to features not yet
    carrying a map point.  A batch of C candidates, all searched at once:
    ``cand`` i64[C] (in range), ``Tcw [C, 4, 4]``, ``cur_mp [C, N]``.
    Returns (cur_mp' [C, N], n_added [C])."""
    M = state.mp_capacity
    N = frame.feats.capacity
    mp = state.kf_mp_idx[cand]                                      # [C, N]
    mpc = mp.clamp(0, M - 1).long()
    valid = state.kf_feat_valid[cand] & (mp >= 0) & state.mp_valid[mpc]
    # skip map points already matched to some feature
    already = mask_from_ids_rows(torch.where(cur_mp >= 0, cur_mp, M), M)
    valid = valid & ~already.gather(-1, mpc)
    m = matcher.search_mappoints_projection(
        cam, Tcw,
        state.mp_pos[mpc], state.mp_normal[mpc],
        state.mp_min_dist[mpc], state.mp_max_dist[mpc], state.mp_desc[mpc],
        valid, frame.feats, cur_mp >= 0,
        th=th, width=width, height=height, scale_factor=scale_factor,
        n_levels=n_levels, max_dist=max_dist, ratio=ratio,
    )
    cur_mp2 = set_drop_rows(cur_mp, torch.where(m.found, m.idx.clamp(0, N - 1), N),
                            torch.where(m.found, mp, -1))
    return cur_mp2, m.found.to(torch.int32).sum(dim=-1)


def reloc_all_candidates(
    state: MapState,
    cam: CameraParams,
    frame: StereoFrame,
    cand_ids: torch.Tensor,   # i32[C], −1 = empty slot
    generator: Optional[torch.Generator] = None,
    *,
    sets: Optional[torch.Tensor] = None,
    u: Optional[torch.Tensor] = None,
    accept: int,
    bow_max_dist: int,
    bow_ratio: float,
    aug_max_dist_wide: int,
    aug_max_dist_narrow: int,
    chi2_mono: float,
    chi2_stereo: float,
    pose_rounds: int,
    pose_iters: int,
    width: int,
    height: int,
    scale_factor: float,
    n_levels: int,
):
    """The whole relocalization candidate cascade without a host read
    (reference Tracking::trackReLocalize, Tracking.cc:531-598): per
    candidate, searchByBow-equivalent matching with ratio, rotation
    consistency and mutual gates (ORBMatcher.cc:170-253), EPnP RANSAC,
    pose-only LM, and both projection-augmentation rounds (th=10 wide, th=3
    narrow, addMatchByProject Tracking.cc:612-629) computed unconditionally,
    with the acceptance cascade selected by masks.

    The C candidate slots run as one batch — every stage carries a leading
    [C] dimension, as the JAX version ``vmap``s them — so a LOST frame
    launches one cascade, not C.  The RANSAC's minimal sets come from
    ``sets`` (integer [C, H, S]) when given, else from the uniform draw
    ``u`` (f32 [C, H, N], ``epnp.uniform_draw``: a captured program takes
    it as an input) or from ``generator``.

    Returns (packed f32[C, 19] = [accepted, n_inliers, cand_id, Tcw.flat],
    cur_mp i32[C, N]): the host fetches only the packed block, and the
    per-feature table of the accepted row alone."""
    M = state.mp_capacity
    N = frame.feats.capacity
    K = state.kf_capacity
    C = cand_ids.shape[0]
    feats = frame.feats
    aug_common = dict(width=width, height=height, scale_factor=scale_factor,
                      n_levels=n_levels, ratio=0.9)
    pose_common = dict(chi2_mono=chi2_mono, chi2_stereo=chi2_stereo,
                       rounds=pose_rounds, iters_per_round=pose_iters)
    inv_s2 = _octave_inv_sigma2(feats.octave, scale_factor)
    is_stereo = frame.right_u > 0

    def obs_of(cur_mp, valid):
        return PoseObs(pw=state.mp_pos[cur_mp.clamp(0, M - 1).long()], uv=feats.uv,
                       right_u=frame.right_u, inv_sigma2=inv_s2, is_stereo=is_stereo, valid=valid)

    cc = cand_ids.clamp(0, K - 1).long()                               # [C]
    live = (cand_ids >= 0) & state.kf_valid[cc]
    kf_mp = state.kf_mp_idx[cc]                                        # [C, N]
    has_mp = state.kf_feat_valid[cc] & (kf_mp >= 0)
    dist = hamming_matrix(feats.desc, state.kf_desc[cc])               # [C, N, N]
    cand_mask = feats.valid[None, :, None] & has_mp[:, None, :] & live[:, None, None]
    m = matcher.best_match(dist, cand_mask, bow_max_dist, bow_ratio)
    keep = matcher.rotation_consistency(
        feats.angle, state.kf_angle[cc].gather(-1, m.idx.clamp(min=0).long()), m.found
    )
    m = matcher.mutual_filter(matcher.MatchResult(idx=torch.where(keep, m.idx, -1), dist=m.dist), N)
    found = m.found
    mp = torch.where(found, kf_mp.gather(-1, m.idx.clamp(0, N - 1).long()), -1)
    n_matches = found.to(torch.int32).sum(dim=-1)

    obs = obs_of(mp, found)
    Tcw0, _, n0 = ransac_pnp(cam, obs.pw, feats.uv, inv_s2, found, generator, sets=sets, u=u)
    Tcw1, inlier1, n1 = optimize_pose(cam, Tcw0, obs, **pose_common)
    cur_mp1 = torch.where(found & inlier1, mp, -1)

    # wide augmentation + re-optimize (unconditional; selected by masks)
    cur_mp_w, n_add_w = reloc_project_augment(
        state, cc, cam, frame, Tcw1, cur_mp1,
        th=10.0, max_dist=aug_max_dist_wide, **aug_common,
    )
    Tcw2, inlier2, n2 = optimize_pose(cam, Tcw1, obs_of(cur_mp_w, cur_mp_w >= 0), **pose_common)
    cur_mp2 = torch.where(inlier2 | (cur_mp_w < 0), cur_mp_w, -1)
    # narrow augmentation: counts only, no further optimization
    # (Tracking.cc:622-627)
    cur_mp_n, n_add_n = reloc_project_augment(
        state, cc, cam, frame, Tcw2, cur_mp2,
        th=3.0, max_dist=aug_max_dist_narrow, **aug_common,
    )

    ok_base = live & (n_matches >= 15) & (n0 >= 10) & (n1 >= 10)
    p_direct = n1 >= accept
    p_wide = (n1 + n_add_w) >= accept
    p_opt2 = n2 >= accept
    p_narrow = (n2 + n_add_n) >= accept
    accepted = ok_base & (p_direct | (p_wide & (p_opt2 | p_narrow)))
    n_fin = torch.where(p_direct, n1, torch.where(p_opt2, n2, n2 + n_add_n))
    Tcw_fin = torch.where(p_direct[:, None, None], Tcw1, Tcw2)
    mp_fin = torch.where(p_direct[:, None], cur_mp1, torch.where(p_opt2[:, None], cur_mp2, cur_mp_n))
    packed = torch.cat([torch.stack([accepted.float(), n_fin.float(), cand_ids.float()], dim=-1),
                        Tcw_fin.reshape(C, 16)], dim=-1)
    return packed, mp_fin


class SLAM:
    """Stereo or RGB-D SLAM on one device — tracking, local mapping and loop
    closing — with the reference's ``System`` API: construct, call
    ``track(left, right)`` (``track(image, depth_map)`` with ``rgbd=True``)
    per frame (reference System::EstimatePose, System.h:55-61), ``flush()``
    at the end of the sequence; ``save(path)`` / ``load(path)`` keep the map
    (npz, or the reference's ``.pb`` and txt formats), and a loaded map is
    localized in by relocalization.

    ``device`` runs everything; with ``cfg.dist.n_devices > 1`` the loop
    closer's essential graph and the GBA shard over ``self.mesh``, the first
    ``n_devices`` of ``devices``; with ``cfg.dist.tracker_mapper_split`` the
    first two of ``devices`` are the tracker's (``self.device``) and the
    map's (``self.map_device``).  ``devices`` defaults to what ``device``
    names (``parallel.mesh.default_devices``): every visible CUDA device for
    a CUDA ``device``, CPU slots for the CPU."""

    def __init__(self, cfg: SLAMConfig, rgbd: bool = False,
                 enable_loop_closing: bool = True, *, device="cuda", devices=None):
        self.cfg = cfg
        # localization mode never closes loops
        self.enable_loop_closing = enable_loop_closing and not cfg.tracking.only_tracking
        self.rgbd = rgbd
        self._split = bool(cfg.dist.tracker_mapper_split)
        if devices is None:
            devices = default_devices(device, max(cfg.dist.n_devices, 2 if self._split else 1))
        # the sharded essential graph and GBA (SURVEY §5.8); one device pays
        # no collective
        self.mesh = (ba_mesh(cfg.dist.n_devices, axis=cfg.dist.mesh_axis, devices=devices)
                     if cfg.dist.n_devices > 1 else None)
        map_device = device
        if self._split:
            devs = local_devices(devices)
            if len(devs) < 2:
                raise ValueError(f"dist.tracker_mapper_split needs ≥2 devices, have {len(devs)}")
            if self.mesh is not None:
                raise ValueError("tracker_mapper_split and a BA mesh are mutually exclusive")
            device, map_device = devs[0], devs[1]
        self.device, self.map_device = _indexed(device), _indexed(map_device)
        self.cam = CameraParams.from_config(cfg.camera, self.device)
        # the map side's copy (the same object without the split)
        self.map_cam = (self.cam if self.map_device == self.device
                        else CameraParams.from_config(cfg.camera, self.map_device))
        # built on the first keyframe registration, by load() or by
        # _ensure_loop_closer(): the vocabulary, the keyframe database and
        # the loop-closing state
        self.loop_closer = None
        o, c, m, t, b = cfg.orb, cfg.camera, cfg.matcher, cfg.tracking, cfg.ba
        # n_init_features does not shape the frontend (max_keypoints does), so
        # the initialization frames share it (the JAX system builds a second,
        # identical program for them)
        self._frontend = (make_rgbd_frontend if rgbd else make_stereo_frontend)(cfg, self.device)
        self._track_common = dict(
            radius=t.motion_search_radius,
            scale_factor=o.scale_factor, n_levels=o.n_levels,
            baseline=c.baseline, width=c.width, height=c.height,
            max_dist=m.min_threshold, ratio_track=m.nn_ratio_track,
            chi2_mono=b.chi2_mono, chi2_stereo=b.chi2_stereo,
            depth_threshold=c.baseline * t.th_depth,
            min_motion_matches=t.min_motion_matches,
            pose_rounds=b.pose_rounds, pose_iters=b.pose_iters_per_round,
        )
        # the relocalization cascade (ratio 0.75 as the reference's reloc
        # ORBMatcher(0.75, true), Tracking.cc:538)
        self._reloc_common = dict(
            accept=t.min_localmap_inliers_reloc,
            bow_max_dist=m.min_threshold, bow_ratio=0.75,
            aug_max_dist_wide=m.max_threshold, aug_max_dist_narrow=m.min_threshold,
            chi2_mono=b.chi2_mono, chi2_stereo=b.chi2_stereo,
            pose_rounds=b.pose_rounds, pose_iters=b.pose_iters_per_round,
            width=c.width, height=c.height, scale_factor=o.scale_factor,
            n_levels=o.n_levels,
        )
        # the map lives in storage that outlasts the programs (``map``): a
        # captured frame graph reads it at fixed addresses
        self._map = empty_map(cfg, self.map_device)
        self._assigned_bytes = 0
        # the frame program as CUDA graphs on a CUDA device (None: the eager
        # program, the CPU path); pinned buffers for images and stats
        # (through a weak reference: the SLAM and its graphs are freed when
        # its last reference goes, not by a garbage collection at any time).
        # With the split the tracker program is the graph, on the tracker
        # device, and it reads the published view as its map storage
        this = weakref.ref(self)
        on_card = self.device.type == "cuda"
        # spans and counters (``time_programs`` turns the spans on), shared
        # with every graph, the pinned ring and the loop closer
        self.tracer = Tracer()
        self._frame_graphs = (FrameGraphs(lambda *a, **kw: this()._graph_frame_program(*a, **kw))
                              if on_card and not self._split else None)
        self._track_graphs = (FrameGraphs(lambda *a, **kw: this().track_program(*a, **kw))
                              if on_card and self._split else None)
        # the keyframe programs and the split's bookkeeping, captured on a
        # CUDA map device (eager elsewhere: the same static buffers and
        # writes into the storage)
        on_map_card = self.map_device.type == "cuda"
        self._kf_graphs = KeyframeGraphs(
            lambda *a: this().map_front_program(*a), lambda *a: this().map_tail_program(*a),
            lambda *a: this()._cull_kfs(*a), lambda *a: this().bookkeep_program(*a), capture=on_map_card)
        # the GBA chunk (over a mesh that Mesh.capturable admits) and commit,
        # and the relocalization query and cascade, likewise
        self._gba_graphs = GBAGraphs(n_iters=1, pcg_iters=b.pcg_iters, chi2_mono=b.chi2_mono,
                                     chi2_stereo=b.chi2_stereo, capture=on_map_card)
        self._reloc_graph = RelocGraph(lambda *a: this().reloc_program(*a), capture=on_map_card)
        for graphs in (self._frame_graphs, self._track_graphs, self._kf_graphs, self._gba_graphs,
                       self._reloc_graph):
            if graphs is not None:
                graphs.tracer = self.tracer
        # the split's published view: (mp_pos, mp_valid) on the tracker
        # device, and the local map on the map device
        self._view: Optional[tuple] = None
        self._local_map: Optional[LocalMap] = None
        if self._split:
            self._refresh_view()
        self._pinned = PinnedRing(self.device) if self.device.type == "cuda" else None
        if self._pinned is not None:
            self._pinned.tracer = self.tracer
        self.state = TrackState.NOT_IMAGE_YET
        self.last: Optional[SlamFrame] = None
        self.velocity = torch.eye(4, dtype=torch.float32, device=self.device)
        self.local: Optional[LocalMap] = None
        self.ref_kf = 0
        self.frame_id = 0
        self.frames_since_kf = 0
        # frame of the last relocalization: opens the wide-search frame and
        # the stricter inlier bar after it, and suppresses keyframes
        self.last_reloc_fid = -(1 << 30)
        self.trajectory: list = []
        # (frame id, reference KF, T_frame←ref) per tracked frame, composed
        # with the final KF poses by final_trajectory() (the reference's
        # mlRelativeFramePoses)
        self._traj_rel: list = []
        self._cur_frame_kf: Optional[int] = None
        # host mirror of the keyframe count (the next keyframe's id), the
        # keyframe whose mapping tail is pending, and the tail bookkeeping
        self._n_kf = 0
        self._pending_kf: Optional[int] = None
        self._kfs_since_ba = 0
        self._tail_counter = 0
        self.frame_times_ms: list = []
        # torch.cuda.set_sync_debug_mode() value applied around the frame
        # program and the keyframe programs only ("error" makes any host
        # synchronisation inside them raise); None leaves the mode alone
        self.frame_sync_debug_mode: Optional[str] = None
        # loop closing: detections dispatched but not read yet, (anchor KF,
        # HostCopy, is_frame_query) in FIFO order; the background GBA in
        # flight; closures so far and the frame of the last one (frame-based
        # suppression of the frame-level queries)
        self._pending_loops: list = []
        self._pending_gba = None
        self.loops_closed = 0
        self._last_closure_fid = -(1 << 30)
        # sync debug mode around the loop stages that may read back (the
        # resolve, the cascade's gate reads, the correction's covisibility
        # read and essential graph, the GBA snapshot and commit); the
        # detection dispatches, the captured cascade stages, the correction's
        # front and fuses, and the GBA chunks take frame_sync_debug_mode
        self.loop_sync_debug_mode: Optional[str] = None
        # pipelined tracking (tracking.pipelined): the dispatched frame not
        # resolved yet, and a relocalization result surfaced on the next call
        self._pipelined = bool(cfg.tracking.pipelined) and not self._split
        self._inflight: Optional[_Inflight] = None
        self._pipeline_carry: Optional[tuple] = None

    # ------------------------------------------------------------------
    @property
    def time_programs(self) -> bool:
        """The tracer's switch (``pipeline.trace``): on, every ``track()``
        call, stage, wait, capture and host read is a host span, and on a
        CUDA device each map-side program (``program_events``) and graph
        replay a device span; off, nothing is recorded."""
        return self.tracer.on

    @time_programs.setter
    def time_programs(self, on: bool) -> None:
        self.tracer.switch(on, (self.device, self.map_device))

    @property
    def program_events(self) -> list:
        """(name, start, end) CUDA events of each map-side program run while
        ``time_programs`` was on (the card only)."""
        return self.tracer.programs

    def trace_counters(self) -> dict:
        """The tracer's counters, with the keyframes inserted and
        ``map_copy_bytes``."""
        return dict(self.tracer.counts, keyframes=self._n_kf, map_copy_bytes=self.map_copy_bytes)

    def trace_export(self, since: Optional[dict] = None) -> dict:
        """``Tracer.export``: the host spans, the device spans placed on the
        host's clock (after the device has finished them: synchronise
        first), and ``trace_counters()`` as deltas from ``since``."""
        return self.tracer.export(self.trace_counters(), since)

    @property
    def map(self) -> MapState:
        return self._map

    @property
    def map_copy_bytes(self) -> int:
        """Bytes copied into the map storage: by map assignments and by the
        keyframe programs', the GBA commit's and the loop graphs' writes."""
        loop = self.loop_closer.copied_bytes if self.loop_closer is not None else 0
        return self._assigned_bytes + self._kf_graphs.copied_bytes + self._gba_graphs.copied_bytes + loop

    @map.setter
    def map(self, new: MapState) -> None:
        """A program that changes the map outside the keyframe graphs (which
        write into the storage themselves) returns a new ``MapState``; its
        changed fields are copied into the storage the graphs read
        (``map_copy_bytes`` counts them), so a keyframe needs no new capture.
        A map of other shapes (a capacity change, a loaded map) becomes the
        storage, as a copy of its own, and the frame, keyframe, GBA and
        relocalization graphs are dropped (the split's tracker graphs too:
        the local map they take changes shape)."""
        cur = self._map
        if new is cur:
            return
        if any(a.shape != b.shape or a.dtype != b.dtype or a.device != b.device
               for a, b in zip(cur, new)):
            self._map = MapState(*(t.clone() for t in new))
            for graphs in (self._frame_graphs, self._track_graphs, self._kf_graphs, self._gba_graphs,
                           self._reloc_graph):
                if graphs is not None:
                    graphs.clear()
            return
        self._assigned_bytes += copy_into(cur, new)

    # ------------------------------------------------------------------
    def frame_program(self, img_l, img_r, last: SlamFrame, velocity, local: LocalMap,
                      mapstate: MapState, ref_kf, *, proj_th: float = 3.0):
        """The per-frame program: frontend + tracking + counter bumps (in
        place on ``mapstate``) + stats + the frame-centred local map.
        ``ref_kf`` is the reference keyframe as an int [1] device tensor (a
        host int is taken too).  Returns (new_state, velocity, host_vec,
        mapstate, local)."""
        new_state, velocity2, hv0, visible, found = self.track_program(
            img_l, img_r, last, velocity, local, (mapstate.mp_pos, mapstate.mp_valid), proj_th=proj_th)
        mapstate, hv1, local2 = self.bookkeep_program(mapstate, local, new_state.mp_ids, visible, found,
                                                      ref_kf)
        return new_state, velocity2, _join_stats(hv0, hv1), mapstate, local2

    def _graph_frame_program(self, *args, **kw):
        """``frame_program`` without its map: the program a frame graph
        replays (the map is the storage it reads and bumps)."""
        new_state, velocity, host_vec, _, local = self.frame_program(*args, **kw)
        return new_state, velocity, host_vec, local

    def track_program(self, img_l, img_r, last: SlamFrame, velocity, local: LocalMap, view,
                      ref_kf=None, *, proj_th: float = 3.0):
        """The tracker's part of the frame: frontend + tracking against
        ``view`` = (mp_pos, mp_valid).  Returns (new_state, velocity, stats
        and pose [23], visible, found); ``ref_kf`` is not read."""
        cur = self._frontend(img_l, img_r, self.cam)
        return slam_track_step(self.cam, cur, last, velocity, local, view[0], view[1],
                               proj_th=proj_th, **self._track_common)

    def bookkeep_program(self, mapstate: MapState, local: LocalMap, mp_ids, visible, found, ref_kf):
        """The map's part of the frame (JAX ``_bookkeep_program``): counter
        bumps (in place), the map-side stats [19] and the frame-centred
        local map.  Returns (mapstate, stats, local)."""
        t = self.cfg.tracking
        mapstate = bump_tracking_counters(mapstate, local, visible, found)
        hv1 = _bookkeep_stats(mapstate, mp_ids, ref_kf, min_obs_bar=t.n_ref_min_obs)
        local2 = local_map_snapshot_frame(mapstate, mp_ids, max_kfs=t.max_local_keyframes,
                                          max_mps=t.max_local_mappoints)
        return mapstate, hv1, local2

    def map_front_program(self, mapstate: MapState, frame: StereoFrame, Tcw, mp_ids, fid, kf_id):
        """Keyframe insertion + the mapping front half: insert → map-point
        cull → triangulate → forward and backward fuse → local-map snapshot
        (reference LocalMapping::runOnce up to the BA, LocalMapping.cc:80-95).
        ``kf_id`` is ``mapstate.next_kf`` (the host mirror ``_n_kf``); it and
        the frame id ``fid`` are host ints or int [1] device tensors.
        Returns (mapstate, local, the keyframe's fused mp_ids, its Tcw)."""
        c, o, t, b, mp = self.cfg.camera, self.cfg.orb, self.cfg.tracking, self.cfg.ba, self.cfg.mapping
        common = dict(scale_factor=o.scale_factor, n_levels=o.n_levels)
        kf_id = kf_index(kf_id, mapstate.kf_Tcw.device)
        mapstate, _ = insert_keyframe(
            mapstate, frame, Tcw, mp_ids, fid, self.map_cam,
            depth_threshold=c.baseline * t.th_depth, min_covis_weight=mp.min_covis_weight,
            seed_floor=mp.seed_far_floor, **common,
        )
        mapstate = cull_mappoints(mapstate, kf_id, cull_score=mp.mp_cull_score)
        mapstate = triangulate_new_points(
            mapstate, kf_id, self.map_cam, n_neighbors=mp.n_triangulate_kfs, baseline=c.baseline,
            rank_gate=mp.triangulation_rank_gate, chi2_mono=b.chi2_mono,
            chi2_stereo=b.chi2_stereo, **common,
        )
        mapstate = fuse_into_keyframe(mapstate, kf_id, self.map_cam, width=c.width, height=c.height, **common)
        if mp.backward_fuse_neighbors > 0:
            mapstate = fuse_keyframe_into_neighbors(
                mapstate, kf_id, self.map_cam, width=c.width, height=c.height,
                n_neighbors=mp.backward_fuse_neighbors, allow_merge=mp.backward_fuse_merge, **common,
            )
        local = self._snapshot(mapstate, kf_id)
        return (mapstate, local, mapstate.kf_mp_idx.index_select(0, kf_id)[0],
                mapstate.kf_Tcw.index_select(0, kf_id)[0])

    def map_tail_program(self, mapstate: MapState, kf_id, do_ba: bool, do_cull: bool):
        """The deferred mapping tail: local BA + keyframe cull + refreshed
        snapshot (LocalMapping.cc:96-109); ``kf_id`` a host int or an int [1]
        device tensor.  Returns (mapstate, local)."""
        b, mp = self.cfg.ba, self.cfg.mapping
        kf_id = kf_index(kf_id, mapstate.kf_Tcw.device)
        if do_ba:
            mapstate = local_ba(
                mapstate, kf_id, self.map_cam,
                max_free=b.max_local_ba_kfs, max_fixed=b.max_local_ba_fixed,
                max_points=b.local_ba_points, chi2_mono=b.chi2_mono, chi2_stereo=b.chi2_stereo,
                lam=b.lm_lambda_init, scale_factor=self.cfg.orb.scale_factor,
                phase_iters=tuple(b.local_ba_phase_iters), erase_in_anchors=b.local_ba_erase_in_anchors,
            )
        if do_cull:
            mapstate = self._cull_kfs(mapstate, kf_id)
        return mapstate, self._snapshot(mapstate, kf_id)

    def _cull_kfs(self, mapstate: MapState, kf_id) -> MapState:
        mp = self.cfg.mapping
        return cull_keyframes(mapstate, kf_id, redundancy=mp.kf_cull_ratio,
                              n_candidates=mp.kf_cull_candidates)

    def _snapshot(self, mapstate: MapState, kf_id) -> LocalMap:
        t = self.cfg.tracking
        return local_map_snapshot(mapstate, kf_id, max_kfs=t.max_local_keyframes,
                                  max_mps=t.max_local_mappoints)

    def _publish_local(self, local: LocalMap, refresh_view: bool = False) -> None:
        """A local map from the map side becomes the tracker's.  With the
        split the tracker gets its own copy, and after a mapping event
        (``refresh_view``: keyframe insertion, the mapping tail, a
        correction, a GBA commit, anything that moves or culls points) the
        (mp_pos, mp_valid) view is refreshed too; between those events the
        tables do not change, so a per-frame refresh would copy the same
        bytes."""
        if not self._split:
            self.local = local
            return
        self._local_map = local
        self.local = tree_map(lambda t: t.to(self.device, copy=True), local)
        if refresh_view:
            self._refresh_view()

    def _refresh_view(self) -> None:
        """Copy (mp_pos, mp_valid) into the tracker's view, in place: a
        captured tracker graph reads it at fixed addresses.  A view of other
        shapes (a capacity change) is new storage and drops the graphs."""
        src = (self.map.mp_pos, self.map.mp_valid)
        if self._view is not None and all(a.shape == b.shape for a, b in zip(self._view, src)):
            for a, b in zip(self._view, src):
                a.copy_(b)
            return
        self._view = tuple(t.to(self.device, copy=True) for t in src)
        if self._track_graphs is not None:
            self._track_graphs.clear()

    def _to_map(self, x):
        """Tensors of the tracker on the map device (themselves without the
        split)."""
        return tree_map(lambda t: t.to(self.map_device), x)

    def _to_tracker(self, x):
        return tree_map(lambda t: t.to(self.device), x)

    @contextlib.contextmanager
    def _sync_guard(self, mode: Optional[str]):
        if mode is None or self.device.type != "cuda":
            yield
            return
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(mode)
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(prev)

    @contextlib.contextmanager
    def _program(self, name: str, sync_mode: Optional[str], reads: bool = False):
        """Run a map-side program under ``sync_mode`` on the map device; with
        ``time_programs`` on, a host span and a device span (one that
        ``reads`` back stays out of the device's busy time)."""
        on_map = (torch.cuda.device(self.map_device) if self.map_device.type == "cuda"
                  else contextlib.nullcontext())
        tr = self.tracer
        with self._sync_guard(sync_mode), on_map, tr.span(name), tr.device_span(name, program=True, reads=reads):
            yield

    def _keyframe_program(self, name: str):
        """A keyframe program, loop-detection dispatch, captured loop stage
        (``LoopCloser.graph_span``) or GBA chunk: no host read allowed
        (``frame_sync_debug_mode``)."""
        return self._program(name, self.frame_sync_debug_mode)

    def _loop_stage(self, name: str):
        """A loop-closing stage that may read back (``loop_sync_debug_mode``)."""
        return self._program(name, self.loop_sync_debug_mode, reads=True)

    def _validate_images(self, img_left, img_right) -> None:
        """Shape gate on the hot path (reference ImageSizeError)."""
        h, w = self.cfg.camera.height, self.cfg.camera.width
        want_color = self.cfg.camera.color != 0
        for name, img, color_ok in (
            ("left", img_left, want_color),
            ("depth" if self.rgbd else "right", img_right, want_color and not self.rgbd),
        ):
            shape = tuple(img.shape)
            ok = shape[:2] == (h, w) and (
                len(shape) == 2 or (len(shape) == 3 and shape[2] in (3, 4) and color_ok)
            )
            if not ok:
                raise ImageSizeError(
                    f"{name} image shape {shape} does not match the configured camera {h}x{w}"
                    + (" (3-channel input requires camera.color != 0)"
                       if len(shape) == 3 and not color_ok else "")
                )

    def _to_device(self, img) -> torch.Tensor:
        """An image on the SLAM's device: a tensor there as it is; host data
        through a pinned buffer and a ``non_blocking`` copy on CUDA (a copy
        from pageable memory would wait for the frame still running)."""
        if torch.is_tensor(img):
            if img.device == self.device:
                return img
            img = img.cpu().numpy()
        if self._pinned is not None:
            return self._pinned.to_device(np.asarray(img))
        return torch.from_numpy(np.array(img)).to(self.device)

    def _run_frame(self, img_l, img_r, last: SlamFrame, velocity, local: LocalMap, wide: bool):
        """One frame program on the live map: the captured graph on CUDA, the
        eager program otherwise (``proj_th`` 5 on the wide-search frame after
        a relocalization).  Returns (new_state, velocity, host_vec, local),
        tensors the caller owns."""
        proj_th = 5.0 if wide else 3.0
        if self._split:
            return self._run_split_frame(img_l, img_r, last, velocity, local, proj_th)
        with self._sync_guard(self.frame_sync_debug_mode):
            if self._frame_graphs is not None:
                return self._frame_graphs.run(img_l, img_r, last, velocity, local, self.map, self.ref_kf,
                                              proj_th=proj_th)
            new_state, velocity, host_vec, self.map, local_new = self.frame_program(
                img_l, img_r, last, velocity, local, self.map, kf_index(self.ref_kf, self.device),
                proj_th=proj_th)
        return new_state, velocity, host_vec, local_new

    def _run_split_frame(self, img_l, img_r, last: SlamFrame, velocity, local: LocalMap, proj_th: float):
        """The split's frame: the tracker program on the tracker device (its
        graph on CUDA) against the view, then the bookkeeping on the map
        device with the frame's (mp_ids, visible, found).  Returns what
        ``_run_frame`` returns, the local map on the map device."""
        with self._sync_guard(self.frame_sync_debug_mode):
            track = self._track_graphs.run if self._track_graphs is not None else self.track_program
            new_state, velocity, hv0, visible, found = track(img_l, img_r, last, velocity, local, self._view, 0,
                                                             proj_th=proj_th)
        with self._keyframe_program("bookkeep"):
            hv1, local_map = self._kf_graphs.bookkeep(self.map, self._local_map,
                                                      *self._to_map((new_state.mp_ids, visible, found)), self.ref_kf)
        return new_state, velocity, _join_stats(hv0, self._to_tracker(hv1)), local_map

    def track(self, img_left, img_right) -> Tuple[Optional[np.ndarray], dict]:
        """Feed one stereo pair, or an image and its depth map in RGB-D mode
        (tensors on the SLAM's device, or arrays that are copied there
        first).  Returns (Tcw as a 4×4 numpy array or None, stats)."""
        self._validate_images(img_left, img_right)
        tr = self.tracer
        tr.count("frames")
        with tr.frame_span(self.frame_id):
            with tr.span("upload"), self._sync_guard(self.frame_sync_debug_mode):
                img_left, img_right = self._to_device(img_left), self._to_device(img_right)
            t0 = time.perf_counter()
            try:
                return self._track_impl(img_left, img_right)
            finally:
                self.frame_times_ms.append((time.perf_counter() - t0) * 1000.0)

    def _track_impl(self, img_left, img_right) -> Tuple[Optional[np.ndarray], dict]:
        fid = self.frame_id
        self.frame_id += 1
        tr = self.tracer

        if self.state in (TrackState.NOT_IMAGE_YET, TrackState.NOT_INITING):
            with tr.span("frontend"):
                frame = self._frontend(img_left, img_right, self.cam)
            if self.n_keyframes > 0:
                # a map exists (loaded or surviving): localize in it instead
                # of re-initializing (the reference's OnlyTracking/reuse mode)
                return self._relocalize(frame, fid)
            return self._initialize(frame, fid)

        if self.state == TrackState.LOST:
            with tr.span("frontend"):
                frame = self._frontend(img_left, img_right, self.cam)
            return self._relocalize(frame, fid)

        if self._pipelined:
            return self._track_pipelined(img_left, img_right, fid)

        t = self.cfg.tracking
        # after a relocalization: one frame of wider projection search, and
        # the stricter inlier bar for max_frames frames
        in_reloc_window = fid < self.last_reloc_fid + t.max_frames
        wide = fid < self.last_reloc_fid + 2
        with tr.span("dispatch"):
            new_state, velocity, host_vec, local_new = self._run_frame(
                img_left, img_right, self.last, self.velocity, self.local, wide)
        frame = new_state.frame
        with tr.span("fetch_wait"):
            host = host_vec.cpu().numpy()  # the ONE device→host sync of the frame
        with tr.span("decide"):
            stats = dict(zip(STAT_KEYS, host[: len(STAT_KEYS)].astype(int).tolist()))
            ns = len(STAT_KEYS)
            pose = host[ns:ns + 16].reshape(4, 4)
            ref_pose = host[ns + 16:ns + 32].reshape(4, 4)
            rk_rec = self.ref_kf  # the reference KF whose pose rode the vector
            self._cur_frame_kf = None
            # acceptance gates (trackLocalMap, Tracking.cc:656-674): ≥ 30 local-map
            # matches, ≥ 30 inliers — ≥ 50 within max_frames of a relocalization
            min_inliers = max(t.min_track_inliers, t.min_localmap_inliers)
            if in_reloc_window:
                min_inliers = t.min_localmap_inliers_reloc
            weak = (
                stats["n_inliers"] < min_inliers
                or stats["n_localmap_matches"] < t.min_localmap_matches
            )
            if weak:
                # fallback: track against the reference keyframe (trackReference,
                # Tracking.cc:360-371) before declaring LOST
                if not self._track_reference(frame, stats):
                    self.state = TrackState.LOST
                    tr.count("lost")
                    return None, stats
                new_state, velocity, Tcw = self._ref_result
                stats["ref_fallback"] = 1
                with tr.span("read"):
                    pose = Tcw.cpu().numpy()

            self.last = new_state
            self.velocity = velocity
            self.frames_since_kf += 1
            if not weak:
                best = stats["best_ref_kf"]
                if best >= 0:
                    self.ref_kf = best
                self._publish_local(local_new)

            if self._need_keyframe(stats):
                self._insert_and_map(new_state, fid, stats)
            elif self._pending_kf is not None:
                # mapper idle: run the deferred BA / culling / loop-detection tail
                self._run_deferred_mapping()
            elif self.loop_closer is not None and self.loop_closer.pending_sim3:
                # advance the deferred Sim3 cascade one stage (the reference's
                # LoopClosing thread mid-verification)
                self._step_pending_sim3()
            elif self._pending_loops:
                # resolve one dispatched detection (its bytes were copied at
                # dispatch; LoopClosing.cc:32-50 draining its queue)
                self._resolve_pending_loop()
            elif self._pending_gba is not None:
                # fully idle: one chunk of the background global BA
                # (LoopClosing.cc:92-169)
                self._step_pending_gba()
            elif self._want_frame_loop_query(fid):
                # starved-keyframe regime: query with this frame's BoW
                self._dispatch_frame_loop_query(new_state)
            if len(self._pending_loops) > 2:
                # keyframe-heavy stretches leave no idle frame: bound the
                # detection lag (the reference's blocking queue, LoopClosing.cc:548-552)
                self._resolve_pending_loop()

            self.trajectory.append((fid, pose))
            # a frame promoted to keyframe references itself
            if self._cur_frame_kf is not None:
                self._traj_rel.append((fid, self._cur_frame_kf, np.eye(4, dtype=np.float32)))
            else:
                self._traj_rel.append((fid, rk_rec, pose @ _rigid_inv(ref_pose)))
            return pose, stats

    # ------------------------------------------------------------------
    # Pipelined tracking (tracking.pipelined=True)
    # ------------------------------------------------------------------
    def _track_pipelined(self, img_left, img_right, fid: int):
        """Dispatch frame ``fid`` speculatively, then resolve frame ``fid − 1``
        while the device runs it: the per-frame fetch and the host's
        decisions (weak check, keyframe decision, mapping dispatch) overlap
        the next frame's device work.  ``track()`` returns the previous
        frame's pose (one frame of latency, as the reference's tracking →
        mapping handoff, LocalMapping.cc:721-726); the last frame resolves in
        ``flush()``.  A weak frame is seen one frame late: its successor is
        re-dispatched from the fallback's corrected state, or, when the frame
        is LOST, the successor's (pose-independent) features relocalize."""
        wide = fid < self.last_reloc_fid + 2
        local_in, last_in = self.local, self.last
        with self.tracer.span("dispatch"):
            new_state, velocity, host_vec, local_new = self._run_frame(
                img_left, img_right, last_in, self.velocity, local_in, wide)
            prev, self._inflight = self._inflight, _Inflight(
                fid, new_state, velocity, self._fetch_async(host_vec), self.ref_kf,
                (img_left, img_right), local_in, last_in)
        self.local = local_new
        self.last = new_state
        self.velocity = velocity
        if prev is None:
            carry, self._pipeline_carry = self._pipeline_carry, None
            return carry if carry is not None else (None, {"pipeline_fill": True})
        return self._resolve_inflight(prev)

    def _fetch_async(self, host_vec: torch.Tensor) -> HostCopy:
        """The stats vector on its way to the host (on CUDA through a pinned
        slot behind an event)."""
        if self._pinned is not None:
            return self._pinned.to_host(host_vec)
        return HostCopy(host_vec)

    def _resolve_inflight(self, prev: "_Inflight"):
        """Resolve one dispatched frame: read its stats vector, run the weak
        and LOST gates, the keyframe decision and the deferred-work
        scheduling — the host half of the synchronous ``_track_impl``, one
        frame late."""
        fid, new_state, velocity, host_fetch, rk_rec, _imgs, local_in, last_in = prev
        tr = self.tracer
        with tr.span("fetch_wait"):
            host = host_fetch.numpy()
        with tr.span("decide"):
            stats = dict(zip(STAT_KEYS, host[: len(STAT_KEYS)].astype(int).tolist()))
            ns = len(STAT_KEYS)
            pose = host[ns:ns + 16].reshape(4, 4).copy()
            ref_pose = host[ns + 16:ns + 32].reshape(4, 4)
            t = self.cfg.tracking
            in_reloc_window = fid < self.last_reloc_fid + t.max_frames
            min_inliers = max(t.min_track_inliers, t.min_localmap_inliers)
            if in_reloc_window:
                min_inliers = t.min_localmap_inliers_reloc
            weak = (
                stats["n_inliers"] < min_inliers
                or stats["n_localmap_matches"] < t.min_localmap_matches
            )
            self._cur_frame_kf = None
            if weak:
                # the fallback starts from the frame this one was dispatched
                # from and keeps the motion model, as the synchronous loop's
                # does (the JAX loop starts from the weak frame's own estimate
                # with the identity velocity, and on a slow start a weak frame
                # then follows every weak frame)
                if not self._track_reference(new_state.frame, stats, last=last_in):
                    self.state = TrackState.LOST
                    tr.count("lost")
                    self._abandon_speculation()
                    return None, stats
                new_state, velocity, Tcw = self._ref_result
                stats["ref_fallback"] = 1
                with tr.span("read"):
                    pose = Tcw.cpu().numpy()
                # the synchronous loop keeps tracking against the local map the
                # weak frame was dispatched with (the JAX loop restores the weak
                # frame's own snapshot here)
                self.local = local_in
                self._redispatch_speculation(new_state, velocity, "weak")
            else:
                best = stats["best_ref_kf"]
                if best >= 0:
                    self.ref_kf = best

            self.frames_since_kf += 1
            if self._need_keyframe(stats, fid):
                self._insert_and_map(new_state, fid, stats)
                # the successor was dispatched against the pre-keyframe map:
                # re-dispatch it from the keyframe's fused state
                self._redispatch_speculation(self.last, velocity, "keyframe")
            elif self._pending_kf is not None:
                self._run_deferred_mapping()
            elif self.loop_closer is not None and self.loop_closer.pending_sim3:
                self._step_pending_sim3()
            elif self._pending_loops:
                self._resolve_pending_loop()
            elif self._pending_gba is not None:
                self._step_pending_gba()
            elif self._want_frame_loop_query(fid):
                self._dispatch_frame_loop_query(new_state)
            if len(self._pending_loops) > 2:
                self._resolve_pending_loop()

            self.trajectory.append((fid, pose))
            if self._cur_frame_kf is not None:
                self._traj_rel.append((fid, self._cur_frame_kf, np.eye(4, dtype=np.float32)))
            else:
                self._traj_rel.append((fid, rk_rec, pose @ _rigid_inv(ref_pose)))
            return pose, stats

    def _redispatch_speculation(self, corr_state: SlamFrame, corr_velocity, cause: str) -> None:
        """Re-dispatch the in-flight successor from a corrected state (a weak
        frame's fallback, a keyframe's fused state, or the last frame moved by
        a loop correction or a GBA commit: ``cause`` "weak", "keyframe" or
        "correction", counted as ``redispatch.<cause>``), with the images kept
        in its record.  The discarded dispatch already bumped the map's
        tracking counters: one frame of slightly-off visible / found counts,
        as in the JAX loop."""
        if self._inflight is None:
            return
        inf = self._inflight
        local_in = self.local
        self.tracer.count(f"redispatch.{cause}")
        with self.tracer.span("redispatch"):
            new_state, velocity, host_vec, local_new = self._run_frame(
                *inf.imgs, corr_state, corr_velocity, local_in, inf.fid < self.last_reloc_fid + 2)
            host = self._fetch_async(host_vec)
        self.local = local_new
        self._inflight = inf._replace(state=new_state, velocity=velocity, host=host, ref_kf=self.ref_kf,
                                      local_in=local_in, last_in=corr_state)
        self.last = new_state
        self.velocity = velocity

    def _abandon_speculation(self) -> None:
        """The resolved frame went LOST: the successor's tracking means
        nothing, but its features do not depend on the pose — relocalize on
        them.  A success is returned by the next ``track()`` call (keeping the
        one-frame delay); a failure leaves the synchronous LOST path to take
        over."""
        if self._inflight is None:
            return
        inf, self._inflight = self._inflight, None
        pose, info = self._relocalize(inf.state.frame, inf.fid)
        if pose is not None:
            self._pipeline_carry = (pose, info)

    def _drain_pipeline(self) -> None:
        """Resolve the in-flight frame (end of the sequence, or before
        anything that must see the final state)."""
        if self._inflight is None:
            return
        prev, self._inflight = self._inflight, None
        self._resolve_inflight(prev)

    # ------------------------------------------------------------------
    def _initialize(self, frame: StereoFrame, fid: int):
        """Stereo initialization: the first frame with enough depth becomes
        keyframe 0 and seeds the map (reference Tracking.cc:104-111)."""
        n_depth = int((frame.depth > 0).sum())
        t = self.cfg.tracking
        if n_depth < t.min_init_depth_kps:
            self.state = TrackState.NOT_INITING
            self._init_failures = getattr(self, "_init_failures", 0) + 1
            if self._init_failures >= t.max_init_failures:
                raise FeatureLessError(
                    f"stereo initialization starved: {self._init_failures} consecutive frames "
                    f"with < {t.min_init_depth_kps} depth keypoints (last: {n_depth})"
                )
            return None, {"init_depth_kps": n_depth}
        self._init_failures = 0
        o, c = self.cfg.orb, self.cfg.camera
        Tcw = torch.eye(4, dtype=torch.float32, device=self.device)
        no_mp = torch.full((frame.feats.capacity,), -1, dtype=torch.int32, device=self.map_device)
        # seeded with insert_keyframe's default floor of 100 nearest far
        # points, as the JAX system's initialization is (mapping.seed_far_floor
        # applies to later keyframes only)
        self.map, kf_id = insert_keyframe(
            self.map, self._to_map(frame), self._to_map(Tcw), no_mp, fid, self.map_cam,
            depth_threshold=c.baseline * t.th_depth,
            scale_factor=o.scale_factor, n_levels=o.n_levels,
            min_covis_weight=self.cfg.mapping.min_covis_weight,
        )
        self.ref_kf = int(kf_id)
        self._n_kf = self.ref_kf + 1
        self._publish_local(self._snapshot(self.map, self.ref_kf), refresh_view=True)
        self.last = SlamFrame(frame=frame, Tcw=Tcw,
                              mp_ids=self.map.kf_mp_idx[self.ref_kf].to(self.device, copy=True))
        self.state = TrackState.OK
        self.frames_since_kf = 0
        pose = Tcw.cpu().numpy()
        self.trajectory.append((fid, pose))
        self._traj_rel.append((fid, self.ref_kf, np.eye(4, dtype=np.float32)))
        return pose, {"initialized": True, "n_mappoints": int(self.map.next_mp)}

    def _track_reference(self, frame: StereoFrame, stats: dict,
                         last: Optional[SlamFrame] = None) -> bool:
        """Reference-keyframe fallback: dense descriptor match to the
        reference KF's map points + pose-only optimization from the last pose
        (reference trackReference, Tracking.cc:360-371); the velocity is the
        motion from that last pose.  Runs only on weak frames, outside the
        frame program, so it may read counts back.  ``last`` is the frame
        tracked before this one when ``self.last`` has moved on (the
        pipelined resolver passes the frame it dispatched the weak one from)."""
        last = self.last if last is None else last
        tr = self.tracer
        tr.count("ref_fallback")
        with tr.span("ref_fallback"):
            kf = self.ref_kf
            # with the split: the keyframe's rows on the tracker (its points are
            # the view's, in _pose_from_mp)
            kf_mp_idx, kf_feat_valid, kf_desc = self._to_tracker(
                (self.map.kf_mp_idx[kf], self.map.kf_feat_valid[kf], self.map.kf_desc[kf]))
            has_mp = kf_feat_valid & (kf_mp_idx >= 0)
            dist = hamming_matrix(frame.feats.desc, kf_desc)
            masked = torch.where(frame.feats.valid[:, None] & has_mp[None, :], dist, 1 << 20)
            best = masked.amin(dim=1)
            bj = masked.argmin(dim=1)
            second = torch.topk(masked, 2, dim=1, largest=False).values[:, 1]
            ok = (best <= self.cfg.matcher.min_threshold) & (
                best.float() < self.cfg.matcher.nn_ratio_bow * second.float()
            )
            with tr.span("read"):
                n_ok = int(ok.to(torch.int32).sum())
            if n_ok < 10:
                return False
            mp = kf_mp_idx[bj]
            Tcw, inlier, n_in = self._pose_from_mp(frame, last.Tcw, torch.where(ok, mp, -1))
            with tr.span("read"):
                n_in = int(n_in)
            if n_in < self.cfg.tracking.min_track_inliers:
                return False
            mp_ids = torch.where(ok & inlier, mp, -1)
            velocity = Tcw @ se3.inverse(last.Tcw)
            stats["n_inliers"] = n_in
            with tr.span("read"):
                stats["n_tracked"] = int((mp_ids >= 0).sum())
            self._ref_result = (SlamFrame(frame=frame, Tcw=Tcw, mp_ids=mp_ids), velocity, Tcw)
            return True

    def _pose_from_mp(self, frame: StereoFrame, Tcw0, cur_mp):
        """Pose-only optimization over the per-feature map-point table
        ``cur_mp`` (−1 = none), from ``Tcw0``, against the tracker's points
        (the split's published view)."""
        mp_pos = self._view[0] if self._split else self.map.mp_pos
        M = mp_pos.shape[0]
        obs = PoseObs(
            pw=mp_pos[cur_mp.clamp(0, M - 1).long()], uv=frame.feats.uv, right_u=frame.right_u,
            inv_sigma2=_octave_inv_sigma2(frame.feats.octave, self.cfg.orb.scale_factor),
            is_stereo=frame.right_u > 0, valid=cur_mp >= 0,
        )
        return optimize_pose(self.cam, Tcw0, obs,
                             chi2_mono=self.cfg.ba.chi2_mono, chi2_stereo=self.cfg.ba.chi2_stereo)

    def _relocalize(self, frame: StereoFrame, fid: int):
        """Relocalization against the keyframe database (reference
        Tracking::trackReLocalize, src/Tracking.cc:531-598): BoW candidates →
        searchByBow-gated matching (ratio 0.75 + rotation consistency) →
        EPnP RANSAC → pose-only optimization → projection augmentation
        rounds th=10 then th=3 — accept only at ≥ 50 inliers.

        Query and cascade are one program without a host read
        (``reloc_program``, replayed as a CUDA graph on the card); the host
        fetches the packed [C, 19] block once, takes the first accepted
        candidate in score order and rebuilds the tracking state around its
        keyframe.  The RANSAC's uniform draw comes from a generator seeded
        with ``fid``, drawn before the replay."""
        if self.loop_closer is None:
            return None, {"reloc": "no_vocab"}
        frame_q = self._to_map(frame)   # the query and the cascade run on the map's device
        gen = torch.Generator(device=self.map_device)
        gen.manual_seed(fid)
        with self._program("relocalize", self.frame_sync_debug_mode):
            u = uniform_draw((RELOC_CANDIDATES,), frame_q.feats.capacity, gen)
            packed_dev, mp_dev = self._reloc_graph(frame_q, u, self.loop_closer.db, self.map,
                                                   self.loop_closer.vocab)
        with self.tracer.span("read"):
            packed = packed_dev.cpu().numpy()  # the ONE fetch of the LOST frame
        info = {"reloc_candidates": int((packed[:, 2] >= 0).sum())}
        acc = packed[:, 0] > 0
        if not acc.any():
            return None, info
        i = int(np.argmax(acc))  # first accepted in candidate (score) order
        cand = int(packed[i, 2])
        pose = packed[i, 3:].reshape(4, 4).copy()
        # accepted: rebuild the tracking state around the matched keyframe
        self.last = SlamFrame(frame=frame, Tcw=packed_dev[i, 3:].reshape(4, 4).to(self.device, copy=True),
                              mp_ids=self._to_tracker(mp_dev[i]))
        self.velocity = torch.eye(4, dtype=torch.float32, device=self.device)
        self.ref_kf = cand
        self._publish_local(self._snapshot(self.map, cand), refresh_view=True)
        self.state = TrackState.OK
        self.last_reloc_fid = fid
        self.trajectory.append((fid, pose))
        with self.tracer.span("read"):
            ref_pose = self.map.kf_Tcw[cand].cpu().numpy()
        self._traj_rel.append((fid, cand, pose @ _rigid_inv(ref_pose)))
        info.update(relocalized=True, reloc_kf=cand, n_inliers=int(packed[i, 1]))
        return pose, info

    def reloc_program(self, frame: StereoFrame, u: torch.Tensor, db: KeyFrameDB, mapstate: MapState,
                      vocab: bow_vocabulary.Vocabulary):
        """The relocalization program of a LOST frame: BoW words and query
        vector, ``find_reloc_candidates``, ``reloc_all_candidates`` with the
        RANSAC's uniform draw ``u`` [C, H, N] (JAX's ``_reloc_query_jit``
        then ``_reloc_fused``).  Returns (packed f32[C, 19], cur_mp i32[C, N])."""
        words = bow_vocabulary.transform(vocab, frame.feats.desc, frame.feats.valid)
        qvec = sparse_bow(vocab, words, self.cfg.bow.max_words_per_query)
        cand_ids, _ = find_reloc_candidates(db, mapstate, qvec, n_words=vocab.n_words,
                                            n_candidates=RELOC_CANDIDATES)
        return reloc_all_candidates(mapstate, self.map_cam, frame, cand_ids, u=u, **self._reloc_common)

    def _warm_reloc(self) -> None:
        """Run the relocalization program once and discard the result, on
        keyframe 0's features against an empty database (every candidate
        slot −1): on the card its graph is captured here, not on a LOST
        frame."""
        if self.loop_closer is None:
            return
        m = self.map
        zeros = torch.zeros_like(m.kf_angle[0])
        frame = StereoFrame(
            feats=FrameFeatures(uv=m.kf_uv[0], uv_raw=m.kf_uv[0], octave=m.kf_octave[0], response=zeros,
                                angle=m.kf_angle[0], desc=m.kf_desc[0], valid=m.kf_feat_valid[0]),
            right_u=m.kf_right_u[0], depth=zeros)
        db = KeyFrameDB.empty(*self.loop_closer.db.word_ids.shape, device=self.map_device)
        u = torch.zeros((RELOC_CANDIDATES, N_HYP, zeros.shape[0]), device=self.map_device)
        with self._program("reloc_warmup", None):
            self._reloc_graph(frame, u, db, m, self.loop_closer.vocab)

    def _need_keyframe(self, stats: dict, fid: Optional[int] = None) -> bool:
        """Keyframe decision (reference needNewKeyFrame, Tracking.cc:721-804):
        c1a cadence / c1b min-cadence + idle mapper / c1c weak tracking or
        close-point need, gated by c2 (tracked ratio below ``ref_ratio_th``
        — 0.4 while the map holds a single KF — or close-point need).  Never
        in localization mode, and suppressed for ``max_frames`` frames after
        a relocalization.  ``fid`` is the frame decided on (the pipelined
        resolver's is one behind the last frame fed)."""
        t = self.cfg.tracking
        if t.only_tracking:
            return False
        if self._n_kf >= self.map.kf_capacity - 1 and not self.cfg.map.auto_grow:
            return False
        if fid is None:
            fid = self.frame_id - 1
        if fid <= self.last_reloc_fid + t.max_frames:
            return False
        # nCurrMps / nRefMps, with nRefMatches computed in the frame program
        ratio = stats["n_tracked"] / max(stats.get("n_ref_matches", 0), 1)
        need_close = (stats["n_close_tracked"] < t.need_close_tracked_th
                      and stats["n_close_untracked"] > t.need_close_untracked_th)
        c1a = self.frames_since_kf > t.max_frames
        c1b = self.frames_since_kf > t.min_frames and self._pending_kf is None
        c1c = ratio < 0.25 or need_close
        ratio_th = 0.4 if self._n_kf < 2 else t.ref_ratio_th
        c2 = ratio < ratio_th or need_close
        return (c1a or c1b or c1c) and c2

    def _insert_and_map(self, cur: SlamFrame, fid: int, stats: dict) -> None:
        """Keyframe insertion + the mapping front half.  The tail (local BA,
        keyframe cull) is deferred to the next idle frame unless
        ``mapping.synchronous``; a keyframe arriving first aborts the
        pending BA (the reference's setAbortBA handshake).  The keyframe's
        fused feature→point table and pose become the tracker's last frame
        (the pipelined resolver re-dispatches the successor from it; every
        JAX caller passes ``adopt_last=True``)."""
        if self.cfg.map.auto_grow:
            if self._n_kf >= self.map.kf_capacity - 2:
                self._grow(kf_capacity=2 * self.map.kf_capacity)
            # one insertion allocates up to ~2N points (seeds + triangulation)
            headroom = 2 * self.cfg.orb.max_keypoints
            if stats.get("next_mp", 0) + headroom >= self.map.mp_capacity:
                self._grow(mp_capacity=2 * self.map.mp_capacity)
        self._flush_pending(next_kf_arriving=True)
        kf_id = self._n_kf
        cur_m = self._to_map(cur)
        with self._keyframe_program("map_front"):
            local, last_mp_ids, last_Tcw = self._kf_graphs.map_front(self.map, cur_m.frame, cur_m.Tcw,
                                                                     cur_m.mp_ids, fid, kf_id)
        self._publish_local(local, refresh_view=True)
        last_mp_ids, last_Tcw = self._to_tracker((last_mp_ids, last_Tcw))
        self._n_kf += 1
        self._pending_kf = kf_id
        if self.cfg.mapping.synchronous:
            self._run_deferred_mapping()
        self.ref_kf = kf_id
        self._cur_frame_kf = kf_id
        # the keyframe is the current frame: adopt its fused feature→point
        # table as the tracker's last frame
        self.last = cur._replace(mp_ids=last_mp_ids, Tcw=last_Tcw)
        self.frames_since_kf = 0

    def _grow(self, kf_capacity: Optional[int] = None, mp_capacity: Optional[int] = None) -> None:
        """Double the store capacities as the allocators approach them; a
        keyframe grow re-snapshots ``local`` (its K-sized mask), re-pads the
        place-recognition rows and, on the card, re-captures the essential
        graph at the new capacity, and the loop graphs and the
        relocalization program on the new storage (the frame, keyframe and
        GBA graphs re-capture at their next use)."""
        self.map = grow_map(self.map, kf_capacity=kf_capacity, mp_capacity=mp_capacity)
        if mp_capacity is not None and self._split:
            self._refresh_view()
        if kf_capacity is not None:
            if self.local is not None:
                self._publish_local(self._snapshot(self.map, self.ref_kf), refresh_view=True)
            if self.loop_closer is not None:
                self.loop_closer.grow(kf_capacity)
                if self.map_device.type == "cuda":
                    self.loop_closer.warm_essential(self.map, self.mesh)
        if self.map_device.type == "cuda":
            if self.loop_closer is not None and self.enable_loop_closing:
                self.loop_closer.warm_graphs(self.map, self.map_cam)
            self._warm_reloc()

    def _flush_pending(self, next_kf_arriving: bool) -> None:
        """Resolve a pending mapping tail.  With the next keyframe already
        arriving, the pending local BA is aborted (its keyframe cull still
        runs) unless ``force_ba_every`` consecutive BAs were aborted."""
        if self._pending_kf is None:
            return
        force = self._kfs_since_ba + 1 >= self.cfg.mapping.force_ba_every
        if next_kf_arriving and not force:
            kf_id = self._pending_kf
            with self._keyframe_program("cull_kfs"):
                self._kf_graphs.cull_kfs(self.map, kf_id)
            # the keyframe still goes to place recognition
            # (LoopClosing::insertKeyFrame receives every keyframe)
            if self.enable_loop_closing:
                self._dispatch_loop_detect(kf_id)
            self._pending_kf = None
            self._kfs_since_ba += 1
        else:
            self._run_deferred_mapping()

    def _run_deferred_mapping(self) -> None:
        """The mapping tail of the pending keyframe, with BA and keyframe
        cull on their ``ba_stride`` / ``kf_cull_stride`` cadence (offset so
        they alternate at stride 2/2; stride 0 disables)."""
        if self._pending_kf is None:
            return
        kf_id, self._pending_kf = self._pending_kf, None
        self._kfs_since_ba = 0
        mp = self.cfg.mapping
        self._tail_counter += 1
        do_ba = mp.ba_stride > 0 and self._tail_counter % mp.ba_stride == 0
        do_cull = mp.kf_cull_stride > 0 and (self._tail_counter + 1) % mp.kf_cull_stride == 0
        with self._keyframe_program("map_tail"):
            local = self._kf_graphs.map_tail(self.map, kf_id, do_ba, do_cull)
        self._publish_local(local, refresh_view=True)
        if self.enable_loop_closing:
            self._dispatch_loop_detect(kf_id)

    # ------------------------------------------------------------------
    def final_trajectory(self) -> list:
        """Each frame's pose relative to its reference keyframe composed with
        that keyframe's final pose (the reference's SaveTrajectoryKITTI);
        culled references are walked up the spanning tree through their
        frozen ``kf_Tcp``.  Returns [(frame id, Tcw 4×4 numpy)] in frame
        order."""
        kf_Tcw = self.map.kf_Tcw.cpu().numpy()
        kf_valid = self.map.kf_valid.cpu().numpy()
        kf_parent = self.map.kf_parent.cpu().numpy()
        kf_Tcp = self.map.kf_Tcp.cpu().numpy()
        live = dict(self.trajectory)
        out = []
        for fid, ref, Trel in self._traj_rel:
            T, r, hops = Trel, int(ref), 0
            while 0 <= r < len(kf_valid) and not kf_valid[r] and hops < 64:
                T = T @ kf_Tcp[r]
                r = int(kf_parent[r])
                hops += 1
            if 0 <= r < len(kf_valid) and kf_valid[r]:
                out.append((fid, (T @ kf_Tcw[r]).astype(np.float32)))
            elif fid in live:  # broken chain: the live pose
                out.append((fid, live[fid]))
        return out

    def flush(self) -> None:
        """Complete the deferred work at the end of a sequence: the mapping
        tail, every pending detection and cascade, the background GBA (the
        reference joins its LoopClosing thread at shutdown).  The pipelined
        loop resolves its in-flight frame first."""
        self._drain_pipeline()
        self._run_deferred_mapping()
        while self._pending_loops or (self.loop_closer is not None and self.loop_closer.pending_sim3):
            if self.loop_closer is not None and self.loop_closer.pending_sim3:
                self._step_pending_sim3()
            else:
                self._resolve_pending_loop()
        while self._pending_gba is not None:
            self._step_pending_gba()

    # ------------------------------------------------------------------
    def _ensure_loop_closer(self, kf_id: int) -> None:
        """Build the vocabulary and an empty keyframe database on first
        need, sized to the live map (it may have auto-grown).  On a CUDA
        device the loop programs are warmed (``_warm_loop_programs``) with
        or without loop closing, as the JAX system warms them on every
        accelerator."""
        if self.loop_closer is not None:
            return
        self.loop_closer = LoopCloser(self.cfg, self._resolve_vocab(kf_id))
        self.loop_closer.tracer = self.tracer
        self.loop_closer.grow(self.map.kf_capacity)
        if self.map_device.type == "cuda":
            self._warm_loop_programs()
        self.loop_closer.span = self._loop_stage
        self.loop_closer.graph_span = self._keyframe_program

    def _warm_loop_programs(self) -> None:
        """Run the loop programs, a GBA chunk (ungated and gated) and its
        commit, and the relocalization program once on the live map and
        discard them, so the first closure or LOST frame pays no one-off
        library load, allocation or capture mid-run (the chunk's graph of
        this map's bucket, the commit's of depth 4).  The map is not changed:
        the warm-up commit's watermarks are 0, which select no keyframe and
        no point, so it writes back the values it reads; keyframe 0 is
        registered in the keyframe database, as the JAX warm-up leaves it."""
        self.loop_closer.warmup(self.map, self.map_cam, mesh=self.mesh)
        phase1 = self.cfg.loop.global_ba_phase_iters[0]
        pend = start_global_ba(self.map, self.cfg.orb.scale_factor)
        for done in (0, phase1):   # the ungated and the gated chunk
            self._gba_chunk(pend._replace(chunks_done=done))
        self._gba_graphs.commit(self.map, pend._replace(snap_next_kf=0, snap_next_mp=0), propagate_depth=4)
        self._warm_reloc()

    def _add_kf_to_db(self, kf_id: int) -> None:
        """Register a keyframe in the place-recognition database
        (LoopClosing::insertKeyFrame)."""
        self._ensure_loop_closer(kf_id)
        self.loop_closer.add_keyframe_to_db(self.map, kf_id)

    def _resolve_vocab(self, kf_id: int):
        """Vocabulary precedence (the reference loads DBoW3's ORBvoc at
        startup, System.cc:92-95): explicit ``bow.vocab_path`` (npz or DBoW
        text) → the packaged pre-trained artifact matching the configured
        tree shape → last-resort training on keyframe ``kf_id``'s own
        descriptors."""
        b = self.cfg.bow
        if b.vocab_path:
            if not os.path.exists(b.vocab_path):
                raise FileNotOpenError(f"vocabulary file not found: {b.vocab_path}")
            if b.vocab_path.endswith(".txt"):
                return bow_vocabulary.load_dbow_text(b.vocab_path, self.map_device)
            return bow_vocabulary.load_vocabulary(b.vocab_path, self.map_device)
        assets_dir = os.path.join(os.path.dirname(__file__), "..", "assets")
        for name in ("vocab_synth_l5.npz", "vocab_synth.npz"):
            asset = os.path.join(assets_dir, name)
            if os.path.exists(asset):
                vocab = bow_vocabulary.load_vocabulary(asset, self.map_device)
                if vocab.branching == b.branching and vocab.depth == b.depth:
                    return vocab
        desc = self.map.kf_desc[kf_id].cpu().numpy()
        valid = self.map.kf_feat_valid[kf_id].cpu().numpy()
        return bow_vocabulary.train_vocabulary(desc[valid], branching=b.branching, depth=b.depth,
                                               device=self.map_device)

    # ------------------------------------------------------------------
    def _dispatch_loop_detect(self, kf_id: int) -> None:
        """Register the keyframe and dispatch loop detection without a host
        read (LoopClosing::insertKeyFrame, LoopClosing.cc:548-552); the
        result joins the pending FIFO, resolved on a later idle frame."""
        self._ensure_loop_closer(kf_id)
        with self._keyframe_program("loop_detect"):
            out = self.loop_closer.detect_async(self.map, kf_id)
        if out is not None:
            self._pending_loops.append((kf_id, out, False))

    def _want_frame_loop_query(self, fid: int) -> bool:
        """Frame-level loop queries fire only in the starved-keyframe regime:
        the cadence bound has passed but the ratio gate keeps blocking
        insertion (LoopConfig.frame_query_stride), and not within 10·MaxFrames
        frames of a closure."""
        stride = self.cfg.loop.frame_query_stride
        t = self.cfg.tracking
        return (
            stride > 0
            and self.enable_loop_closing
            and self.loop_closer is not None
            and self.frames_since_kf > t.max_frames
            and fid - self._last_closure_fid >= 10 * t.max_frames
            and fid % stride == 0
        )

    def _dispatch_frame_loop_query(self, state: SlamFrame) -> None:
        """Dispatch a frame-BoW candidate query (no registration) anchored at
        the tracking reference keyframe; it feeds the same chains."""
        desc, valid = self._to_map((state.frame.feats.desc, state.frame.feats.valid))
        with self._keyframe_program("loop_detect"):
            out = self.loop_closer.detect_frame_async(self.map, desc, valid, int(self.ref_kf))
        if out is not None:
            self._pending_loops.append((int(self.ref_kf), out, True))

    def _resolve_pending_loop(self) -> bool:
        """Read and resolve the oldest dispatched detection; a surviving
        candidate starts the deferred Sim3 cascade (stage A)."""
        kf_id, out, is_frame = self._pending_loops.pop(0)
        with self._loop_stage("resolve"):
            cand = self.loop_closer.detect_resolve(kf_id, out, kf_window=not is_frame)
            if cand is not None:
                self.tracer.count("loop.candidates")
                self.loop_closer.sim3_begin(self.map, self.map_cam, kf_id, cand)
        return False

    def _step_pending_sim3(self) -> bool:
        """Advance the cascade one stage; once verified, correct the loop
        (group propagation, fuses, essential graph), snapshot the background
        GBA and re-anchor the tracker (LoopClosing.cc:53-169)."""
        with self._loop_stage("sim3_step"):
            res = self.loop_closer.sim3_step(self.map, self.map_cam)
        if res is None:
            return False
        kf_id, cand, S12, matched_mp, group = res
        # a GBA in flight dies with the new closure (LoopClosing.cc:87)
        if self._pending_gba is not None:
            self.tracer.count("gba.aborted")
        self._pending_gba = None
        ref_before = self.map.kf_Tcw[self.ref_kf].clone()
        with self._loop_stage("correct"):
            self.map = self.loop_closer.correct(self.map, self.map_cam, kf_id, cand, S12, matched_mp, group,
                                                run_gba=False, mesh=self.mesh, in_place=True)
        with self._loop_stage("gba_start"):
            self._pending_gba = start_global_ba(self.map, self.cfg.orb.scale_factor)
        self.loops_closed += 1
        self.tracer.count("loop.closures")
        self._last_closure_fid = self.frame_id
        # detections dispatched before the correction carry pre-closure
        # candidates and chains
        self._pending_loops.clear()
        self.loop_closer.consistent_groups = []
        self._publish_local(self._snapshot(self.map, self.ref_kf), refresh_view=True)
        self._reanchor_tracker(ref_before)
        return True

    def _gba_chunk(self, pending):
        """One chunk of ``pending`` through ``GBAGraphs.step`` over the
        SLAM's mesh (which runs it eagerly over a mesh that is not
        capturable)."""
        return self._gba_graphs.step(pending, self.map_cam, robust_after=self.cfg.loop.global_ba_phase_iters[0],
                                     capacity=(self.map.kf_capacity, self.map.mp_capacity), mesh=self.mesh)

    def _step_pending_gba(self) -> None:
        """One background-GBA chunk; the commit after the last one."""
        with self._keyframe_program("gba_chunk"):
            self._pending_gba = self._gba_chunk(self._pending_gba)
        self.tracer.count("gba.chunks")
        if self._pending_gba.chunks_done >= sum(self.cfg.loop.global_ba_phase_iters):
            self._commit_pending_gba()

    def _commit_pending_gba(self) -> None:
        """Commit the finished GBA onto the live map (LoopClosing.cc:101-166)
        and re-anchor the tracker on it."""
        ref_before = self.map.kf_Tcw[self.ref_kf].clone()
        with self._loop_stage("gba_commit"):
            self._gba_graphs.commit(self.map, self._pending_gba)
        self._pending_gba = None
        self._publish_local(self._snapshot(self.map, self.ref_kf), refresh_view=True)
        self._reanchor_tracker(ref_before)

    def _reanchor_tracker(self, ref_before: torch.Tensor) -> None:
        """Apply the correction that moved the reference keyframe to the
        tracker.  ``ref_before`` must be a copy: the correction replaces
        ``kf_Tcw``, and a view of the old row would make the delta the
        identity if it were written in place.

        The pipelined loop's frame in flight was tracked against the map
        before the correction: its pose, its matches and its local map are
        the old map's, and moving its pose by the reference keyframe's
        correction leaves it off by whatever the fuses and the essential
        graph moved its own points beyond that (resolved at that pose, it
        would hand the next frame, and any keyframe it inserts, a pose off
        its points).  So it is re-dispatched against the corrected
        map (``redispatch.correction``), as the synchronous loop tracks the
        frame after a correction: from the frame it was dispatched from,
        moved by the correction, with the velocity it measured (a motion
        between two frames tracked on the same map, which one correction of
        both leaves as it was).  With no frame in flight the last frame
        moves and the motion model restarts from the identity, as in the
        JAX system (which restarts it with a frame in flight too, and moves
        that frame only when it is the same object as the last one)."""
        if self.last is None:
            return
        delta = self._to_tracker(se3.inverse(ref_before) @ self.map.kf_Tcw[self.ref_kf])
        inf = self._inflight
        if inf is None:
            self.last = self.last._replace(Tcw=self.last.Tcw @ delta)
            self.velocity = torch.eye(4, dtype=torch.float32, device=self.device)
            return
        self._redispatch_speculation(inf.last_in._replace(Tcw=inf.last_in.Tcw @ delta), inf.velocity,
                                     "correction")

    def run_global_ba(self, mesh=None) -> None:
        """Full-map bundle adjustment now (reference globalOptimization),
        sharded over ``mesh`` or the SLAM's own."""
        self.map = global_ba(self.map, self.map_cam, scale_factor=self.cfg.orb.scale_factor,
                             pcg_iters=self.cfg.ba.pcg_iters, mesh=mesh or self.mesh,
                             axis=self.cfg.dist.mesh_axis)
        if self.local is not None:
            self._publish_local(self._snapshot(self.map, self.ref_kf), refresh_view=True)

    @staticmethod
    def _is_txt_path(path: str) -> bool:
        """A directory path (trailing separator, or an existing directory)
        names the reference's txt streams."""
        return path.endswith(("/", os.sep)) or bool(os.altsep and path.endswith(os.altsep)) \
            or os.path.isdir(path)

    def save(self, path: str) -> None:
        """Persist the map (reference map save at shutdown,
        System.cc:194-198).  A ``.pb`` path writes the reference's protobuf
        MapData (Map.cc:200-249); a directory path writes the reference's
        txt streams KeyFrames.txt + MapPoints.txt (Map.cc:82-108); otherwise
        ``<path>.map.npz`` and, when a loop closer exists, its vocabulary as
        ``<path>.vocab.npz`` — the JAX package's native files."""
        self.flush()
        vocab = self.loop_closer.vocab if self.loop_closer is not None else None
        if path.endswith(".pb"):
            save_proto_map(path, self.map, self.cfg, vocab=vocab)
            return
        if self._is_txt_path(path):
            save_txt_map(path, self.map, self.cfg, vocab=vocab)
            return
        if not os.path.splitext(path)[1]:
            print(f"[slam] save path {path!r} has no extension and is not a directory — writing "
                  f"native npz; append '/' for the reference txt format or '.pb' for protobuf",
                  file=sys.stderr)
        save_map(path + ".map.npz", self.map, self.cfg)
        if vocab is not None:
            bow_vocabulary.save_vocabulary(vocab, path + ".vocab.npz")

    def load(self, path: str) -> None:
        """Load a map for continued SLAM or localization-only reuse
        (reference System.cc:98-110 + OnlyTracking mode): a ``.pb`` path as
        reference protobuf, a directory as the reference's txt streams (both
        with the vocabulary ``_resolve_vocab`` finds), else the npz stem with
        the vocabulary saved beside it.  The keyframe database is rebuilt
        (System.cc:104-110) and the next frame relocalizes."""
        candidates = (path, path + ".map.npz", path + os.sep)
        if not any(os.path.exists(p) for p in candidates):
            raise FileNotOpenError(f"map not found at {path!r} (tried {candidates})")
        vocab = None
        if path.endswith(".pb") or self._is_txt_path(path):
            reader = load_proto_map if path.endswith(".pb") else load_txt_map
            self.map = reader(path, self.cfg, self.map_device)
            vocab = self._resolve_vocab(0)
        else:
            self.map, _ = load_map(path + ".map.npz", self.map_device)
            if os.path.exists(path + ".vocab.npz"):
                vocab = bow_vocabulary.load_vocabulary(path + ".vocab.npz", self.map_device)
        if self._split:
            self._refresh_view()
        self._n_kf = int(self.map.next_kf)
        if vocab is not None:
            self.loop_closer = LoopCloser(self.cfg, vocab)
            self.loop_closer.tracer = self.tracer
            self.loop_closer.span = self._loop_stage
            self.loop_closer.graph_span = self._keyframe_program
            self.loop_closer.db = rebuild(vocab, self.map, max_words=self.cfg.bow.max_words_per_query)
            self._reloc_graph.clear()   # a new vocabulary
            if self.map_device.type == "cuda":
                self._warm_reloc()
        self.state = TrackState.NOT_INITING

    # ------------------------------------------------------------------
    @property
    def n_keyframes(self) -> int:
        return int(self.map.kf_valid.sum())

    @property
    def n_mappoints(self) -> int:
        return int(self.map.mp_valid.sum())
