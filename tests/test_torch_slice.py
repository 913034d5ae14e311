"""End-to-end parity of the port's localization-mode SLAM with the JAX
package's, on the CPU, at the small configuration of
``__graft_entry__.entry()``.

Frames are rendered once by the JAX package and handed to both systems.
Frames 0-3: the same TrackState sequence, each pose within 5 mm and 0.05°,
n_inliers within 3%.  (The JAX system seeds 162 points here and loses track
at frame 5 as the camera leaves keyframe 0's view.)
"""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)

import orb_slam2_ros2_tpu.config as jcfg
import orb_slam2_ros2_tpu_torch.config as tcfg
from orb_slam2_ros2_tpu.io.synthetic import SyntheticStereoDataset as JDataset
from orb_slam2_ros2_tpu.pipeline.system import SLAM as JSLAM
from orb_slam2_ros2_tpu_torch.errors import ImageSizeError
from orb_slam2_ros2_tpu_torch.pipeline.system import SLAM as TSLAM
from orb_slam2_ros2_tpu_torch.pipeline.tracking import TrackState

N_FRAMES = 4


def small_cfg(mod, **tracking):
    """The small configuration of ``__graft_entry__.entry()``, localization mode."""
    return mod.SLAMConfig(
        camera=mod.CameraConfig(fx=200.0, fy=200.0, cx=160.0, cy=96.0, baseline=0.5,
                                width=320, height=192),
        orb=mod.ORBConfig(n_features=500, max_keypoints=512),
        tracking=mod.TrackingConfig(**{**dict(min_init_depth_kps=150, max_local_mappoints=4096,
                                              max_local_keyframes=16, only_tracking=True),
                                       **tracking}),
        map=mod.MapConfig(max_keyframes=64, max_mappoints=16384, max_obs_per_mp=16),
    )


@pytest.fixture(scope="module")
def frames():
    ds = JDataset(small_cfg(jcfg).camera, n_frames=N_FRAMES, speed=0.35)
    return [tuple(np.asarray(x) for x in ds.frame(i)) for i in range(N_FRAMES)]


@pytest.fixture(scope="module")
def runs(frames):
    """(states, poses, stats) of each system over the frames."""
    out = {}
    for name, slam in (("jax", JSLAM(small_cfg(jcfg), enable_loop_closing=False)),
                       ("torch", TSLAM(small_cfg(tcfg), enable_loop_closing=False, device="cpu"))):
        states, poses, stats = [], [], []
        for img_l, img_r, _ in frames:
            pose, st = slam.track(img_l, img_r)
            states.append(slam.state)
            poses.append(pose)
            stats.append(st)
        out[name] = (states, poses, stats, slam)
    return out


def test_track_states_equal(runs):
    js, ts = runs["jax"][0], runs["torch"][0]
    assert [s.name for s in ts] == [s.name for s in js]
    assert all(s.name == "OK" for s in ts)


@pytest.mark.parametrize("i", range(N_FRAMES))
def test_pose_and_inliers_agree(runs, i):
    pj, pt = runs["jax"][1][i], runs["torch"][1][i]
    sj, st = runs["jax"][2][i], runs["torch"][2][i]
    assert np.abs(pt[:3, 3] - pj[:3, 3]).max() <= 5e-3
    dR = pt[:3, :3].astype(np.float64).T @ pj[:3, :3]
    ang = 0.5 * np.linalg.norm([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]])
    assert np.degrees(ang) <= 0.05
    if i == 0:
        assert st["n_mappoints"] == sj["n_mappoints"]
    else:
        assert abs(st["n_inliers"] - sj["n_inliers"]) <= 0.03 * sj["n_inliers"]


def test_map_and_counters_agree(runs):
    """After the run the two maps hold the same points and the same
    visible/found counters (the frame program bumps them in place)."""
    jm, tm = runs["jax"][3].map, runs["torch"][3].map
    assert int(tm.next_mp) == int(jm.next_mp)
    np.testing.assert_array_equal(tm.mp_valid.numpy(), np.asarray(jm.mp_valid))
    vis_j, vis_t = np.asarray(jm.mp_visible), tm.mp_visible.numpy()
    assert vis_t.sum() > np.asarray(jm.mp_valid).sum()  # counters moved
    assert np.abs(vis_t - vis_j).sum() <= 0.03 * vis_j.sum()


@pytest.mark.parametrize("refused", ["rgbd", "pipelined", "split", "n_devices", "mapping"])
def test_unported_modes_are_refused(refused):
    """Every mode is ported: RGB-D, the pipelined loop, mapping with loop
    closing, the tracker/mapper split and a BA mesh each construct, also
    together with the split over two CPU devices; what is refused is what
    the JAX system refuses — the split with one device (every case) and the
    split together with a BA mesh — and the split turns the pipelined loop
    off."""
    cfg = small_cfg(tcfg)
    kw = {}
    two = ("cpu", "cpu")

    def split(c):
        return c.replace(dist=dataclasses.replace(c.dist, tracker_mapper_split=True))

    if refused == "rgbd":
        kw["rgbd"] = True
        assert TSLAM(cfg, device="cpu", **kw).rgbd
        assert TSLAM(split(cfg), devices=two, **kw).rgbd
    elif refused == "pipelined":
        cfg = small_cfg(tcfg, pipelined=True)
        assert TSLAM(cfg, device="cpu")._pipelined
        assert not TSLAM(split(cfg), devices=two)._pipelined
    elif refused == "split":
        slam = TSLAM(split(cfg), devices=two)
        assert slam._split and slam.mesh is None and slam._view is not None
    elif refused == "n_devices":
        cfg = cfg.replace(dist=dataclasses.replace(cfg.dist, n_devices=2))
        assert TSLAM(cfg, device="cpu", devices=two).mesh.size == 2
        with pytest.raises(ValueError, match="mutually exclusive"):
            TSLAM(split(cfg), devices=two)
    else:
        cfg = small_cfg(tcfg, only_tracking=False)
        assert TSLAM(cfg, device="cpu").enable_loop_closing
        assert TSLAM(split(cfg), devices=two).enable_loop_closing
    with pytest.raises(ValueError, match="≥2 devices"):
        TSLAM(split(cfg), devices=("cpu",), **kw)


def test_initialization_seeds_like_jax(frames):
    """Keyframe 0 is topped up to ``insert_keyframe``'s default floor of 100
    seeds with the nearest far points, as the JAX system's initialization
    does: ``mapping.seed_far_floor`` (here 40) applies to later keyframes
    only.  A close-depth threshold of 4 m leaves fewer close points than
    either floor, so the floor decides the count."""
    from orb_slam2_ros2_tpu_torch.mapstate.map_state import empty_map, insert_keyframe

    def cfg(mod):
        c = small_cfg(mod, th_depth=8.0)
        return c.replace(mapping=dataclasses.replace(c.mapping, seed_far_floor=40))

    _, sj = JSLAM(cfg(jcfg), enable_loop_closing=False).track(*frames[0][:2])
    ts = TSLAM(cfg(tcfg), enable_loop_closing=False, device="cpu")
    _, st = ts.track(*frames[0][:2])
    assert st["n_mappoints"] == sj["n_mappoints"] == 100
    c = cfg(tcfg)
    seeded_40, _ = insert_keyframe(
        empty_map(c, "cpu"), ts.last.frame, torch.eye(4), torch.full_like(ts.last.mp_ids, -1), 0,
        ts.cam, depth_threshold=c.camera.baseline * c.tracking.th_depth,
        scale_factor=c.orb.scale_factor, n_levels=c.orb.n_levels, seed_floor=40)
    assert int(seeded_40.next_mp) == 40


def test_lost_frame_reports_no_vocab(frames):
    slam = TSLAM(small_cfg(tcfg), device="cpu")
    slam.track(*frames[0][:2])
    slam.state = TrackState.LOST
    assert slam.track(*frames[1][:2]) == (None, {"reloc": "no_vocab"})


def test_wrong_image_size_raises():
    slam = TSLAM(small_cfg(tcfg), device="cpu")
    with pytest.raises(ImageSizeError):
        slam.track(np.zeros((100, 100), np.float32), np.zeros((100, 100), np.float32))


def test_sync_guard_is_inert_on_cpu(frames):
    """The sync-debug guard applies to CUDA only; on the CPU the frame
    program runs unchanged."""
    slam = TSLAM(small_cfg(tcfg), device="cpu")
    slam.frame_sync_debug_mode = "error"
    for img_l, img_r, _ in frames[:2]:
        pose, _ = slam.track(torch.from_numpy(img_l), torch.from_numpy(img_r))
    assert slam.state == TrackState.OK and pose is not None
