"""The paths a long run takes, on the CPU: the port's ``SLAM`` on the
adversarial world against the JAX package's, and the frame-level loop
queries.

* A short adversarial run (the configuration of ``tests/test_adversarial.py``
  at 320×192, 20 frames of its 80-frame lap) in both packages, both fed the
  same frames rendered by the JAX package, so that the comparison is of the
  SLAM and not of the renderer: the same TrackState and keyframe count after
  every frame, every pose within 1 cm / 0.1° (the tolerance of
  ``tests/test_torch_pipelined.py``), the same final keyframe and map-point
  counts.
* ``SLAM._want_frame_loop_query`` decides as JAX's over a grid of
  (frames since the last keyframe, frame id, last closure, stride, loop
  closing on or off, a loop closer or none).
* The mechanism test of JAX ``tests/test_loop_closing.py`` on the port's
  ``SLAM`` (the adversarial run's): in the starved-keyframe regime a frame
  query is dispatched into the pending FIFO, resolving it runs the chain
  bookkeeping, and a keyframe-dense system does not query.
"""

import itertools

import numpy as np
import pytest
from test_torch_adversarial import adversarial_cfg
from test_torch_mapping import rot_deg, two_torch_threads  # noqa: F401  (autouse)

import orb_slam2_ros2_tpu.config as jcfg
import orb_slam2_ros2_tpu_torch.config as tcfg
from orb_slam2_ros2_tpu.io.synthetic import AdversarialStereoDataset as JDataset
from orb_slam2_ros2_tpu.pipeline import system as jsys
from orb_slam2_ros2_tpu_torch.pipeline import system as tsys

LAP, N_FRAMES = 80, 20
POSE_TOL_M, POSE_TOL_DEG = 1e-2, 0.1


def run(slam, frames) -> dict:
    out = dict(states=[], n_kf=[], poses=[])
    for img_l, img_r, _ in frames:
        pose, _ = slam.track(img_l, img_r)
        out["states"].append(slam.state.name)
        out["n_kf"].append(slam._n_kf)
        out["poses"].append(pose)
    slam.flush()
    out["slam"] = slam
    return out


@pytest.fixture(scope="module")
def runs():
    ds = JDataset(adversarial_cfg(jcfg).camera, n_frames=N_FRAMES, frames_per_lap=LAP)
    frames = [tuple(np.asarray(x) for x in ds.frame(i)) for i in range(N_FRAMES)]
    return dict(jax=run(jsys.SLAM(adversarial_cfg(jcfg)), frames),
                torch=run(tsys.SLAM(adversarial_cfg(tcfg), device="cpu"), frames))


def test_adversarial_run_matches_jax(runs):
    j, t = runs["jax"], runs["torch"]
    assert t["states"] == j["states"] and all(s == "OK" for s in t["states"])
    assert t["n_kf"] == j["n_kf"] and t["n_kf"][-1] >= 10
    Pj, Pt = np.stack(j["poses"]), np.stack(t["poses"])
    # Tcw: compare the camera centres and the rotations
    Cj, Ct = np.linalg.inv(Pj.astype(np.float64)), np.linalg.inv(Pt.astype(np.float64))
    assert np.abs(Cj[:, :3, 3] - Ct[:, :3, 3]).max() <= POSE_TOL_M
    assert rot_deg(Pj, Pt).max() <= POSE_TOL_DEG
    assert t["slam"].n_keyframes == j["slam"].n_keyframes
    assert t["slam"].n_mappoints == j["slam"].n_mappoints


class _Gate:
    """The attributes ``_want_frame_loop_query`` reads."""

    def __init__(self, cfg, enable, closer, since_kf, last_closure):
        self.cfg, self.enable_loop_closing, self.loop_closer = cfg, enable, closer
        self.frames_since_kf, self._last_closure_fid = since_kf, last_closure


@pytest.mark.parametrize("stride", [0, 1, 2, 3])
def test_want_frame_loop_query_matches_jax(stride):
    cfgs = {}
    for name, mod in (("jax", jcfg), ("torch", tcfg)):
        c = adversarial_cfg(mod)
        cfgs[name] = c.replace(loop=c.loop.__class__(frame_query_stride=stride))
    max_frames = cfgs["torch"].tracking.max_frames
    fired = 0
    grid = itertools.product((True, False), (object(), None), (0, max_frames, max_frames + 1, 5 * max_frames),
                             range(90, 130), (-(1 << 30), -10 * max_frames, -10 * max_frames + 1, 0))
    for enable, closer, since_kf, fid, since_closure in grid:
        state = (enable, closer, since_kf, fid + since_closure)
        want = jsys.SLAM._want_frame_loop_query(_Gate(cfgs["jax"], *state), fid)
        got = tsys.SLAM._want_frame_loop_query(_Gate(cfgs["torch"], *state), fid)
        assert got == want, (enable, closer, since_kf, fid, since_closure)
        fired += got
    assert (fired > 0) == (stride > 0)


def test_frame_level_loop_queries_feed_chains(runs):
    """JAX ``tests/test_loop_closing.py``'s mechanism test on the port: a
    starved system dispatches frame queries into the pending FIFO, and
    resolving them runs the chain bookkeeping as keyframe detections do.
    (Runs last: it changes the run's SLAM.)"""
    slam = runs["torch"]["slam"]
    assert slam.loop_closer is not None and slam._n_kf >= 10
    c = slam.cfg
    # force the starved regime: many frames passed with no keyframe
    slam.frames_since_kf = c.tracking.max_frames + 1
    stride = c.loop.frame_query_stride
    fid = slam.frame_id + (stride - slam.frame_id % stride) % stride   # land on the stride
    assert slam._want_frame_loop_query(fid)
    n_pending = len(slam._pending_loops)
    slam.ref_kf = max(int(slam.ref_kf), 10)   # clear the young-map suppression
    slam.loop_closer.last_loop_kf = -100
    slam._dispatch_frame_loop_query(slam.last)
    assert len(slam._pending_loops) == n_pending + 1
    assert slam._pending_loops[-1][0] == slam.ref_kf and slam._pending_loops[-1][2]   # a frame query
    slam._resolve_pending_loop()
    assert isinstance(slam.loop_closer.consistent_groups, list)
    # a keyframe-dense system does not frame-query
    slam.frames_since_kf = 0
    assert not slam._want_frame_loop_query(fid)
