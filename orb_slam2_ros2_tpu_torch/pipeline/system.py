"""The SLAM system: stereo tracking + local mapping with local BA, no loop
closing.

Port of ``orb_slam2_ros2_tpu/pipeline/system.py`` (reference src/System.cc,
src/Tracking.cc, src/LocalMapping.cc).  Frame 0 initializes the map from
stereo depth (one keyframe); every later frame runs ONE frame program —
frontend → motion-model match + pose-only LM → local-map projection match +
a second LM → counter bumps, stats and the frame-centred local-map refresh —
and the host reads ONE stats vector back.  Outside localization mode
(``tracking.only_tracking=False``) the host then decides on a keyframe; a
keyframe runs the mapping front program (insert → map-point cull →
triangulate → two-way fuse → snapshot), and the deferred tail program
(local BA → keyframe cull → snapshot) runs on the next idle frame, or at
once with ``mapping.synchronous``.  None of the three programs synchronises
with the host (no ``.item()``, boolean-mask indexing or host copies), which
``SLAM.frame_sync_debug_mode`` can enforce.

Not ported yet, and refused by ``SLAM.__init__``: loop closing (so mapping
needs ``enable_loop_closing=False``), RGB-D, the pipelined loop, the
tracker/mapper split and multi-device BA.  Relocalization needs the BoW
vocabulary of the loop closer: a LOST frame returns
``(None, {"reloc": "no_vocab"})`` exactly as the JAX system does without a
loop closer.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import SLAMConfig
from ..features.extractor import make_stereo_frontend
from ..features.frame import StereoFrame
from ..geometry import se3
from ..geometry.camera import CameraParams, project, unproject
from ..mapstate.local_map import (
    LocalMap,
    bump_tracking_counters,
    local_map_snapshot,
    local_map_snapshot_frame,
)
from ..mapstate.map_state import MapState, empty_map, grow_map, insert_keyframe
from ..mapstate.mapping import (
    cull_keyframes,
    cull_mappoints,
    fuse_into_keyframe,
    fuse_keyframe_into_neighbors,
    triangulate_new_points,
)
from ..matching import matcher
from ..ops.hamming import hamming_matrix
from ..solvers.local_ba import local_ba
from ..solvers.pose_opt import PoseObs, optimize_pose
from ..utils import count_into, mask_from_ids, set_drop
from .tracking import TrackState


class SlamFrame(NamedTuple):
    """Per-frame tracking result kept as 'last frame' state."""

    frame: StereoFrame
    Tcw: torch.Tensor
    mp_ids: torch.Tensor   # i32[N] map point per feature (−1 = none)


def _rigid_inv(T: np.ndarray) -> np.ndarray:
    """Host-side SE(3) inverse (transpose form)."""
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = T[:3, :3].T
    out[:3, 3] = -T[:3, :3].T @ T[:3, 3]
    return out


def _octave_inv_sigma2(octave: torch.Tensor, scale_factor: float) -> torch.Tensor:
    return torch.pow(1.0 / (scale_factor * scale_factor), octave.float())


def _select(c: torch.Tensor, a: matcher.MatchResult, b: matcher.MatchResult) -> matcher.MatchResult:
    return matcher.MatchResult(idx=torch.where(c, a.idx, b.idx), dist=torch.where(c, a.dist, b.dist))


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
):
    """One full tracking step (motion model + local map), mirroring
    Tracking::trackMotionModel + trackLocalMap (reference Tracking.cc:381-406,
    :641-675).  Returns (new frame state, velocity, host stats vector,
    visible mask, found mask) — the masks aligned with ``local``."""
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
    c2 = m2.idx.clamp(0, N - 1).long()
    cur_mp = set_drop(cur_mp, torch.where(m2.found, m2.idx, N), local.mp_ids)

    visible = vis[1] & local.valid
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


def _bookkeep_stats(mapstate: MapState, mp_ids: torch.Tensor, ref_kf: int,
                    min_obs_bar: int = 3) -> torch.Tensor:
    """Map-side per-frame stats vector [19]: best_ref, next_mp, nRefMatches
    (reference-KF points with ≥ nMinObs observations, 2 while the map holds
    ≤ 2 keyframes), ref-KF pose (flat 16)."""
    best_ref = _best_ref_kf(mapstate, mp_ids)
    rk = min(max(int(ref_kf), 0), mapstate.kf_capacity - 1)
    rmp = mapstate.kf_mp_idx[rk]
    rmpc = rmp.clamp(0, mapstate.mp_capacity - 1).long()
    nkfs = mapstate.kf_valid.to(torch.int32).sum()
    min_obs = torch.where(nkfs <= 2, 2, min_obs_bar)
    n_ref = (
        mapstate.kf_feat_valid[rk] & (rmp >= 0) & mapstate.mp_valid[rmpc]
        & (mapstate.mp_n_obs[rmpc] >= min_obs)
    ).to(torch.int32).sum().float()
    return torch.cat([
        torch.stack([best_ref, mapstate.next_mp.float(), n_ref]),
        mapstate.kf_Tcw[rk].reshape(-1),
    ])


class SLAM:
    """Stereo SLAM on one device, tracking + local mapping without loop
    closing — the reference's ``System`` API: construct, call
    ``track(left, right)`` per frame (reference System::EstimatePose,
    System.h:55-61), ``flush()`` at the end of the sequence."""

    def __init__(self, cfg: SLAMConfig, rgbd: bool = False,
                 enable_loop_closing: bool = True, *, device="cuda"):
        if rgbd:
            raise NotImplementedError("rgbd=True: the RGB-D frontend is not ported yet (ROADMAP port queue: RGB-D frontend)")
        if cfg.tracking.pipelined:
            raise NotImplementedError("tracking.pipelined: the pipelined loop is not ported yet (ROADMAP port queue: pipelined loop)")
        if cfg.dist.tracker_mapper_split:
            raise NotImplementedError("dist.tracker_mapper_split is not ported yet (ROADMAP port queue: multi-GPU)")
        if cfg.dist.n_devices > 1:
            raise NotImplementedError("dist.n_devices > 1 is not ported yet (ROADMAP port queue: multi-GPU)")
        if enable_loop_closing and not cfg.tracking.only_tracking:
            raise NotImplementedError(
                "enable_loop_closing=True with tracking.only_tracking=False: loop closing is not "
                "ported yet (ROADMAP port queue: loop closing); pass enable_loop_closing=False")
        # localization mode never closes loops, so the flag is inert there
        self.cfg = cfg
        self.device = torch.device(device)
        self.cam = CameraParams.from_config(cfg.camera, self.device)
        o, c, m, t, b = cfg.orb, cfg.camera, cfg.matcher, cfg.tracking, cfg.ba
        # n_init_features does not shape the frontend (max_keypoints does), so
        # the initialization frames share it
        self._frontend = make_stereo_frontend(cfg, self.device)
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
        self.map = empty_map(cfg, self.device)
        self.state = TrackState.NOT_IMAGE_YET
        self.last: Optional[SlamFrame] = None
        self.velocity = torch.eye(4, dtype=torch.float32, device=self.device)
        self.local: Optional[LocalMap] = None
        self.ref_kf = 0
        self.frame_id = 0
        self.frames_since_kf = 0
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
        # on a CUDA device, True brackets each keyframe program by CUDA
        # events, appended to program_events as (name, start, end)
        self.time_programs = False
        self.program_events: list = []

    # ------------------------------------------------------------------
    def frame_program(self, img_l, img_r, last: SlamFrame, velocity, local: LocalMap,
                      mapstate: MapState, ref_kf: int, *, proj_th: float = 3.0):
        """The per-frame program: frontend + tracking + counter bumps (in
        place on ``mapstate``) + stats + the frame-centred local map.
        Returns (new_state, velocity, host_vec, mapstate, local)."""
        t = self.cfg.tracking
        cur = self._frontend(img_l, img_r, self.cam)
        new_state, velocity2, host_vec, visible, found = slam_track_step(
            self.cam, cur, last, velocity, local, mapstate.mp_pos, mapstate.mp_valid,
            proj_th=proj_th, **self._track_common,
        )
        mapstate = bump_tracking_counters(mapstate, local, visible, found)
        # layout: [STAT_KEYS..., Tcw.flat(16), Tcw_refkf.flat(16)]
        bk = _bookkeep_stats(mapstate, new_state.mp_ids, ref_kf, min_obs_bar=t.n_ref_min_obs)
        n_stat = host_vec.shape[0] - 16
        host_vec = torch.cat([host_vec[:n_stat], bk[:3], host_vec[n_stat:], bk[3:]])
        local2 = local_map_snapshot_frame(mapstate, new_state.mp_ids,
                                          max_kfs=t.max_local_keyframes,
                                          max_mps=t.max_local_mappoints)
        return new_state, velocity2, host_vec, mapstate, local2

    def map_front_program(self, mapstate: MapState, frame: StereoFrame, Tcw, mp_ids,
                          fid: int, kf_id: int):
        """Keyframe insertion + the mapping front half: insert → map-point
        cull → triangulate → forward and backward fuse → local-map snapshot
        (reference LocalMapping::runOnce up to the BA, LocalMapping.cc:80-95).
        ``kf_id`` is the host mirror of ``mapstate.next_kf``.  Returns
        (mapstate, local, the keyframe's fused mp_ids, its Tcw)."""
        c, o, t, b, mp = self.cfg.camera, self.cfg.orb, self.cfg.tracking, self.cfg.ba, self.cfg.mapping
        common = dict(scale_factor=o.scale_factor, n_levels=o.n_levels)
        mapstate, _ = insert_keyframe(
            mapstate, frame, Tcw, mp_ids, fid, self.cam,
            depth_threshold=c.baseline * t.th_depth, min_covis_weight=mp.min_covis_weight,
            seed_floor=mp.seed_far_floor, **common,
        )
        mapstate = cull_mappoints(mapstate, kf_id, cull_score=mp.mp_cull_score)
        mapstate = triangulate_new_points(
            mapstate, kf_id, self.cam, n_neighbors=mp.n_triangulate_kfs, baseline=c.baseline,
            rank_gate=mp.triangulation_rank_gate, chi2_mono=b.chi2_mono,
            chi2_stereo=b.chi2_stereo, **common,
        )
        mapstate = fuse_into_keyframe(mapstate, kf_id, self.cam, width=c.width, height=c.height, **common)
        if mp.backward_fuse_neighbors > 0:
            mapstate = fuse_keyframe_into_neighbors(
                mapstate, kf_id, self.cam, width=c.width, height=c.height,
                n_neighbors=mp.backward_fuse_neighbors, allow_merge=mp.backward_fuse_merge, **common,
            )
        local = self._snapshot(mapstate, kf_id)
        return mapstate, local, mapstate.kf_mp_idx[kf_id].clone(), mapstate.kf_Tcw[kf_id].clone()

    def map_tail_program(self, mapstate: MapState, kf_id: int, do_ba: bool, do_cull: bool):
        """The deferred mapping tail: local BA + keyframe cull + refreshed
        snapshot (LocalMapping.cc:96-109).  Returns (mapstate, local)."""
        b, mp = self.cfg.ba, self.cfg.mapping
        if do_ba:
            mapstate = local_ba(
                mapstate, kf_id, self.cam,
                max_free=b.max_local_ba_kfs, max_fixed=b.max_local_ba_fixed,
                max_points=b.local_ba_points, chi2_mono=b.chi2_mono, chi2_stereo=b.chi2_stereo,
                lam=b.lm_lambda_init, scale_factor=self.cfg.orb.scale_factor,
                phase_iters=tuple(b.local_ba_phase_iters),
            )
        if do_cull:
            mapstate = self._cull_kfs(mapstate, kf_id)
        return mapstate, self._snapshot(mapstate, kf_id)

    def _cull_kfs(self, mapstate: MapState, kf_id: int) -> MapState:
        mp = self.cfg.mapping
        return cull_keyframes(mapstate, kf_id, redundancy=mp.kf_cull_ratio,
                              n_candidates=mp.kf_cull_candidates)

    def _snapshot(self, mapstate: MapState, kf_id: int) -> LocalMap:
        t = self.cfg.tracking
        return local_map_snapshot(mapstate, kf_id, max_kfs=t.max_local_keyframes,
                                  max_mps=t.max_local_mappoints)

    @contextlib.contextmanager
    def _sync_guard(self):
        mode = self.frame_sync_debug_mode
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
    def _keyframe_program(self, name: str):
        """Dispatch a keyframe program under the sync guard, bracketed by
        CUDA events when ``time_programs`` is on."""
        with self._sync_guard():
            if not (self.time_programs and self.device.type == "cuda"):
                yield
                return
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self.program_events.append((name, start, end))

    def _validate_images(self, img_left, img_right) -> None:
        """Shape gate on the hot path (reference ImageSizeError)."""
        from ..errors import ImageSizeError

        h, w = self.cfg.camera.height, self.cfg.camera.width
        want_color = self.cfg.camera.color != 0
        for name, img in (("left", img_left), ("right", img_right)):
            shape = tuple(img.shape)
            ok = shape[:2] == (h, w) and (
                len(shape) == 2 or (len(shape) == 3 and shape[2] in (3, 4) and want_color)
            )
            if not ok:
                raise ImageSizeError(
                    f"{name} image shape {shape} does not match the configured camera {h}x{w}"
                    + (" (3-channel input requires camera.color != 0)"
                       if len(shape) == 3 and not want_color else "")
                )

    def _to_device(self, img) -> torch.Tensor:
        if torch.is_tensor(img):
            return img.to(self.device)
        return torch.from_numpy(np.array(img)).to(self.device)

    def track(self, img_left, img_right) -> Tuple[Optional[np.ndarray], dict]:
        """Feed one stereo pair (tensors on the SLAM's device, or arrays that
        are copied there first).  Returns (Tcw as a 4×4 numpy array or None,
        stats)."""
        self._validate_images(img_left, img_right)
        img_left, img_right = self._to_device(img_left), self._to_device(img_right)
        t0 = time.perf_counter()
        try:
            return self._track_impl(img_left, img_right)
        finally:
            self.frame_times_ms.append((time.perf_counter() - t0) * 1000.0)

    def _track_impl(self, img_left, img_right) -> Tuple[Optional[np.ndarray], dict]:
        fid = self.frame_id
        self.frame_id += 1

        if self.state in (TrackState.NOT_IMAGE_YET, TrackState.NOT_INITING):
            frame = self._frontend(img_left, img_right, self.cam)
            if self.n_keyframes > 0:
                return self._relocalize(frame, fid)
            return self._initialize(frame, fid)

        if self.state == TrackState.LOST:
            frame = self._frontend(img_left, img_right, self.cam)
            return self._relocalize(frame, fid)

        # (no relocalization is ported, so the JAX system's post-relocalization
        # window — wider search, 50-inlier bar — never opens here)
        t = self.cfg.tracking
        with self._sync_guard():
            new_state, velocity, host_vec, new_map, local_new = self.frame_program(
                img_left, img_right, self.last, self.velocity, self.local, self.map,
                self.ref_kf,
            )
        self.map = new_map
        frame = new_state.frame
        host = host_vec.cpu().numpy()  # the ONE device→host sync of the frame
        stats = dict(zip(STAT_KEYS, host[: len(STAT_KEYS)].astype(int).tolist()))
        ns = len(STAT_KEYS)
        pose = host[ns:ns + 16].reshape(4, 4)
        ref_pose = host[ns + 16:ns + 32].reshape(4, 4)
        rk_rec = self.ref_kf  # the reference KF whose pose rode the vector
        self._cur_frame_kf = None
        # acceptance gates (trackLocalMap, Tracking.cc:656-674)
        min_inliers = max(t.min_track_inliers, t.min_localmap_inliers)
        weak = (
            stats["n_inliers"] < min_inliers
            or stats["n_localmap_matches"] < t.min_localmap_matches
        )
        if weak:
            # fallback: track against the reference keyframe (trackReference,
            # Tracking.cc:360-371) before declaring LOST
            if not self._track_reference(frame, stats):
                self.state = TrackState.LOST
                return None, stats
            new_state, velocity, Tcw = self._ref_result
            stats["ref_fallback"] = 1
            pose = Tcw.cpu().numpy()

        self.last = new_state
        self.velocity = velocity
        self.frames_since_kf += 1
        if not weak:
            best = stats["best_ref_kf"]
            if best >= 0:
                self.ref_kf = best
            self.local = local_new

        if self._need_keyframe(stats):
            self._insert_and_map(new_state, fid, stats)
        elif self._pending_kf is not None:
            # mapper idle: run the deferred BA / culling tail
            self._run_deferred_mapping()

        self.trajectory.append((fid, pose))
        # a frame promoted to keyframe references itself
        if self._cur_frame_kf is not None:
            self._traj_rel.append((fid, self._cur_frame_kf, np.eye(4, dtype=np.float32)))
        else:
            self._traj_rel.append((fid, rk_rec, pose @ _rigid_inv(ref_pose)))
        return pose, stats

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
                from ..errors import FeatureLessError

                raise FeatureLessError(
                    f"stereo initialization starved: {self._init_failures} consecutive frames "
                    f"with < {t.min_init_depth_kps} depth keypoints (last: {n_depth})"
                )
            return None, {"init_depth_kps": n_depth}
        self._init_failures = 0
        o, c = self.cfg.orb, self.cfg.camera
        Tcw = torch.eye(4, dtype=torch.float32, device=self.device)
        no_mp = torch.full((frame.feats.capacity,), -1, dtype=torch.int32, device=self.device)
        # seeded with insert_keyframe's default floor of 100 nearest far
        # points, as the JAX system's initialization is (mapping.seed_far_floor
        # applies to later keyframes only)
        self.map, kf_id = insert_keyframe(
            self.map, frame, Tcw, no_mp, fid, self.cam,
            depth_threshold=c.baseline * t.th_depth,
            scale_factor=o.scale_factor, n_levels=o.n_levels,
            min_covis_weight=self.cfg.mapping.min_covis_weight,
        )
        self.ref_kf = int(kf_id)
        self._n_kf = self.ref_kf + 1
        self.local = self._snapshot(self.map, self.ref_kf)
        self.last = SlamFrame(frame=frame, Tcw=Tcw, mp_ids=self.map.kf_mp_idx[self.ref_kf].clone())
        self.state = TrackState.OK
        self.frames_since_kf = 0
        pose = Tcw.cpu().numpy()
        self.trajectory.append((fid, pose))
        self._traj_rel.append((fid, self.ref_kf, np.eye(4, dtype=np.float32)))
        return pose, {"initialized": True, "n_mappoints": int(self.map.next_mp)}

    def _track_reference(self, frame: StereoFrame, stats: dict) -> bool:
        """Reference-keyframe fallback: dense descriptor match to the
        reference KF's map points + pose-only optimization from the last pose
        (reference trackReference, Tracking.cc:360-371).  Runs only on weak
        frames, outside the frame program, so it may read counts back."""
        kf = self.ref_kf
        M = self.map.mp_capacity
        kf_mp_idx = self.map.kf_mp_idx[kf]
        has_mp = self.map.kf_feat_valid[kf] & (kf_mp_idx >= 0)
        dist = hamming_matrix(frame.feats.desc, self.map.kf_desc[kf])
        masked = torch.where(frame.feats.valid[:, None] & has_mp[None, :], dist, 1 << 20)
        best = masked.amin(dim=1)
        bj = masked.argmin(dim=1)
        second = torch.topk(masked, 2, dim=1, largest=False).values[:, 1]
        ok = (best <= self.cfg.matcher.min_threshold) & (
            best.float() < self.cfg.matcher.nn_ratio_bow * second.float()
        )
        if int(ok.to(torch.int32).sum()) < 10:
            return False
        mp = kf_mp_idx[bj]
        inv_s2 = _octave_inv_sigma2(frame.feats.octave, self.cfg.orb.scale_factor)
        obs = PoseObs(pw=self.map.mp_pos[mp.clamp(0, M - 1).long()], uv=frame.feats.uv,
                      right_u=frame.right_u, inv_sigma2=inv_s2,
                      is_stereo=frame.right_u > 0, valid=ok)
        Tcw, inlier, n_in = optimize_pose(
            self.cam, self.last.Tcw, obs,
            chi2_mono=self.cfg.ba.chi2_mono, chi2_stereo=self.cfg.ba.chi2_stereo,
        )
        if int(n_in) < self.cfg.tracking.min_track_inliers:
            return False
        mp_ids = torch.where(ok & inlier, mp, -1)
        velocity = Tcw @ se3.inverse(self.last.Tcw)
        stats["n_inliers"] = int(n_in)
        stats["n_tracked"] = int((mp_ids >= 0).sum())
        self._ref_result = (SlamFrame(frame=frame, Tcw=Tcw, mp_ids=mp_ids), velocity, Tcw)
        return True

    def _relocalize(self, frame: StereoFrame, fid: int):
        """Relocalization needs the loop closer's BoW vocabulary, which is
        not ported: like the JAX system without a loop closer
        (``orb_slam2_ros2_tpu/pipeline/system.py:1319-1320``), it reports
        ``no_vocab``."""
        return None, {"reloc": "no_vocab"}

    def _need_keyframe(self, stats: dict) -> bool:
        """Keyframe decision (reference needNewKeyFrame, Tracking.cc:721-804):
        c1a cadence / c1b min-cadence + idle mapper / c1c weak tracking or
        close-point need, gated by c2 (tracked ratio below ``ref_ratio_th``
        — 0.4 while the map holds a single KF — or close-point need).  Never
        in localization mode.  (No relocalization is ported, so the JAX
        system's post-relocalization suppression never applies.)"""
        t = self.cfg.tracking
        if t.only_tracking:
            return False
        if self._n_kf >= self.map.kf_capacity - 1 and not self.cfg.map.auto_grow:
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
        pending BA (the reference's setAbortBA handshake)."""
        if self.cfg.map.auto_grow:
            if self._n_kf >= self.map.kf_capacity - 2:
                self._grow(kf_capacity=2 * self.map.kf_capacity)
            # one insertion allocates up to ~2N points (seeds + triangulation)
            headroom = 2 * self.cfg.orb.max_keypoints
            if stats.get("next_mp", 0) + headroom >= self.map.mp_capacity:
                self._grow(mp_capacity=2 * self.map.mp_capacity)
        self._flush_pending(next_kf_arriving=True)
        kf_id = self._n_kf
        with self._keyframe_program("map_front"):
            self.map, self.local, last_mp_ids, last_Tcw = self.map_front_program(
                self.map, cur.frame, cur.Tcw, cur.mp_ids, fid, kf_id)
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
        keyframe grow re-snapshots ``local`` (its K-sized mask)."""
        self.map = grow_map(self.map, kf_capacity=kf_capacity, mp_capacity=mp_capacity)
        if kf_capacity is not None and self.local is not None:
            self.local = self._snapshot(self.map, self.ref_kf)

    def _flush_pending(self, next_kf_arriving: bool) -> None:
        """Resolve a pending mapping tail.  With the next keyframe already
        arriving, the pending local BA is aborted (its keyframe cull still
        runs) unless ``force_ba_every`` consecutive BAs were aborted."""
        if self._pending_kf is None:
            return
        force = self._kfs_since_ba + 1 >= self.cfg.mapping.force_ba_every
        if next_kf_arriving and not force:
            with self._keyframe_program("cull_kfs"):
                self.map = self._cull_kfs(self.map, self._pending_kf)
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
            self.map, self.local = self.map_tail_program(self.map, kf_id, do_ba, do_cull)

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
        """Complete the deferred mapping work (end of sequence)."""
        self._run_deferred_mapping()

    # ------------------------------------------------------------------
    @property
    def n_keyframes(self) -> int:
        return int(self.map.kf_valid.sum())

    @property
    def n_mappoints(self) -> int:
        return int(self.map.mp_valid.sum())
