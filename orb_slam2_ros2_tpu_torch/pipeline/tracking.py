"""Tracking states and the motion-model odometry core (port of
``orb_slam2_ros2_tpu/pipeline/tracking.py``; reference Tracking.h:12-18,
Tracking.cc:381-406).

States: NOT_IMAGE_YET → NOT_INITING → OK ⇄ LOST.

``OdometryTracker`` is the minimum end-to-end slice: stereo
initialization, then motion-model matching against the previous frame's
stereo-unprojected points and a pose-only LM, frame after frame.  The full
``SLAM`` adds mapping, local-map tracking, relocalization and loop closing.
``make_fused_odometry_step`` is the same step with the stereo frontend in
front, the counterpart of the JAX package's jitted step: on CUDA it is
captured as one CUDA graph at first use and replayed every call.
"""

from __future__ import annotations

import enum
from functools import partial
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import SLAMConfig
from ..features.frame import StereoFrame
from ..geometry import se3
from ..geometry.camera import CameraParams, unproject
from ..matching import matcher
from ..solvers.pose_opt import PoseObs, optimize_pose


class TrackState(enum.Enum):
    NOT_IMAGE_YET = 0
    NOT_INITING = 1
    OK = 2
    LOST = 3


class TrackedFrame(NamedTuple):
    """Per-frame tracking state handed between steps, on the device."""

    frame: StereoFrame
    Tcw: torch.Tensor      # f32[4, 4]
    pw: torch.Tensor       # f32[N, 3] world points unprojected from stereo depth
    has_pw: torch.Tensor   # bool[N]


def unproject_frame(cam: CameraParams, frame: StereoFrame, Tcw: torch.Tensor):
    """Per-keypoint world points from stereo depth (the reference's temporary
    map points of the last frame, Tracking.cc:685-694): (pw [N, 3], ok [N])."""
    ok = frame.feats.valid & (frame.depth > 0.0)
    pc = unproject(cam, frame.feats.uv, torch.where(ok, frame.depth, 1.0))
    return se3.apply(se3.inverse(Tcw), pc), ok


def motion_track_step(
    cam: CameraParams,
    cur: StereoFrame,
    last: TrackedFrame,
    velocity: torch.Tensor,
    *,
    radius: float,
    scale_factor: float,
    n_levels: int,
    baseline: float,
    max_dist: int,
    ratio: float,
    sigma2_base: float,
    chi2_mono: float,
    chi2_stereo: float,
    pose_rounds: int = 4,
    pose_iters: int = 10,
):
    """One motion-model tracking step (trackMotionModel, Tracking.cc:381-406):
    predict the pose with the velocity model, match the last frame's
    keypoints that carry 3D to the current keypoints around their image
    positions (forward/backward octave windows), then optimize the pose.

    Returns (Tcw_opt, n_matches, n_inliers, match, inlier), all on the
    device."""
    Tcw_pred = velocity @ last.Tcw
    # z of the current camera's origin in the last camera's frame picks the
    # forward / backward octave window
    twc_cur = se3.t_of(se3.inverse(Tcw_pred))
    z_forward = se3.apply(last.Tcw, twc_cur[None])[0, 2]

    cur_taken = torch.zeros(cur.feats.capacity, dtype=torch.bool, device=velocity.device)
    m = matcher.search_by_area(
        last.frame.feats, last.has_pw, cur.feats, cur_taken, z_forward,
        radius=radius, scale_factor=scale_factor, n_levels=n_levels,
        baseline=baseline, max_dist=max_dist, ratio=ratio,
    )
    n_matches = m.found.sum()

    cidx = m.idx.clamp(min=0).long()
    right_u = cur.right_u[cidx]
    obs = PoseObs(
        pw=last.pw,
        uv=cur.feats.uv[cidx],
        right_u=right_u,
        inv_sigma2=torch.pow(1.0 / sigma2_base, cur.feats.octave[cidx].float()),
        is_stereo=right_u > 0,
        valid=m.found,
    )
    Tcw_opt, inlier, n_inliers = optimize_pose(
        cam, Tcw_pred, obs, chi2_mono=chi2_mono, chi2_stereo=chi2_stereo,
        rounds=pose_rounds, iters_per_round=pose_iters,
    )
    return Tcw_opt, n_matches, n_inliers, m, inlier


def _step_kw(cfg: SLAMConfig) -> dict:
    """``motion_track_step``'s parameters for ``cfg`` but the radius."""
    o, c, m, b = cfg.orb, cfg.camera, cfg.matcher, cfg.ba
    return dict(
        scale_factor=o.scale_factor, n_levels=o.n_levels, baseline=c.baseline,
        max_dist=m.min_threshold, ratio=m.nn_ratio_track,
        sigma2_base=o.scale_factor * o.scale_factor,
        chi2_mono=b.chi2_mono, chi2_stereo=b.chi2_stereo,
        pose_rounds=b.pose_rounds, pose_iters=b.pose_iters_per_round,
    )


def odometry_program(cfg: SLAMConfig, device):
    """The fused step as an eager function ``(cam, img_l, img_r, last,
    velocity) → (new_last, velocity, Tcw, n_matches, n_inliers)``: the stereo
    frontend (one FAST and one patch launch on CUDA), ``motion_track_step``,
    the velocity update and ``unproject_frame``, with no host read."""
    from ..features.extractor import make_stereo_frontend

    frontend = make_stereo_frontend(cfg, device)
    track = partial(motion_track_step, radius=cfg.tracking.motion_search_radius, **_step_kw(cfg))

    def step(cam: CameraParams, img_l, img_r, last: TrackedFrame, velocity):
        cur = frontend(img_l, img_r, cam)
        Tcw, n_matches, n_inliers, _, _ = track(cam, cur, last, velocity)
        velocity_new = Tcw @ se3.inverse(last.Tcw)
        pw, has = unproject_frame(cam, cur, Tcw)
        return TrackedFrame(frame=cur, Tcw=Tcw, pw=pw, has_pw=has), velocity_new, Tcw, n_matches, n_inliers

    return step


def make_fused_odometry_step(cfg: SLAMConfig, device="cuda"):
    """One device-resident frame step: images in, pose and new state out
    (``odometry_program``).  On CUDA it is a ``StepGraph``: captured as one
    CUDA graph at first use (that call runs eagerly) and replayed after,
    inputs copied in and outputs cloned; elsewhere the eager function."""
    from .frame_graph import StepGraph

    program = odometry_program(cfg, device)
    return StepGraph(program) if torch.device(device).type == "cuda" else program


class OdometryTracker:
    """Stereo visual odometry, the minimum end-to-end slice: motion-model
    tracking against the previous frame's stereo-unprojected points, with
    the reference's 2× radius retry (Tracking.cc:388-391) and its match and
    inlier gates."""

    def __init__(self, cfg: SLAMConfig, cam: Optional[CameraParams] = None, device="cuda"):
        self.cfg = cfg
        self.cam = cam if cam is not None else CameraParams.from_config(cfg.camera, device)
        t = cfg.tracking
        self._step = partial(motion_track_step, radius=t.motion_search_radius, **_step_kw(cfg))
        self._step_wide = partial(motion_track_step, radius=t.motion_search_radius * 2, **_step_kw(cfg))
        self.state = TrackState.NOT_IMAGE_YET
        self.last: Optional[TrackedFrame] = None
        self.velocity = torch.eye(4, dtype=torch.float32, device=self.cam.fx.device)
        self.min_matches = t.min_motion_matches
        self.min_inliers = t.min_track_inliers

    def track(self, frame: StereoFrame) -> Tuple[Optional[np.ndarray], dict]:
        """Feed one frame; returns (Tcw as numpy, or None while initializing
        or when lost, and info)."""
        info = {}
        if self.state in (TrackState.NOT_IMAGE_YET, TrackState.NOT_INITING):
            n_depth = int((frame.depth > 0).sum())
            if n_depth < self.cfg.tracking.min_init_depth_kps:
                self.state = TrackState.NOT_INITING
                return None, {"init_depth_kps": n_depth}
            Tcw = torch.eye(4, dtype=torch.float32, device=frame.depth.device)
            pw, has = unproject_frame(self.cam, frame, Tcw)
            self.last = TrackedFrame(frame=frame, Tcw=Tcw, pw=pw, has_pw=has)
            self.state = TrackState.OK
            return Tcw.cpu().numpy(), {"initialized": True, "init_depth_kps": n_depth}

        Tcw, n_m, n_in, _, _ = self._step(self.cam, frame, self.last, self.velocity)
        n_m, n_in = torch.stack([n_m, n_in]).tolist()
        if n_m < self.min_matches:
            Tcw, n_m, n_in, _, _ = self._step_wide(self.cam, frame, self.last, self.velocity)
            n_m, n_in = torch.stack([n_m, n_in]).tolist()
            info["wide_retry"] = True
        info.update(n_matches=n_m, n_inliers=n_in)

        if n_in < self.min_inliers:
            self.state = TrackState.LOST
            return None, info

        self.velocity = Tcw @ se3.inverse(self.last.Tcw)
        pw, has = unproject_frame(self.cam, frame, Tcw)
        self.last = TrackedFrame(frame=frame, Tcw=Tcw, pw=pw, has_pw=has)
        self.state = TrackState.OK
        return Tcw.cpu().numpy(), info
