"""The port's tracker/mapper split (``dist.tracker_mapper_split``) on the
CPU, the counterpart of ``tests/test_split_mode.py``: the tracker device
runs the frontend and the tracking step against a published view of the
map, the map device owns the map and runs the bookkeeping and the keyframe
programs.  Here both are the CPU (``devices=("cpu", "cpu")``), so the
published view is checked to be a copy by its storage, where the JAX test
compares devices.

* the split's poses equal the single-device run's within JAX's 5e-4 on
  every frame, with the same keyframe count (the view is refreshed after
  exactly the events that change the tables it holds): 14 frames of the
  JAX test's world, whose own test is ``slow`` at 26 (a keyframe every
  frame), and 4 localization frames of ``test_torch_slice.py`` (no mapping
  event after the first frame: the tracker works from the view published
  at the initialization);
* the final trajectory covers every frame;
* the view and the tracker's local map do not share storage with the map;
* JAX's refusals (the split with one device; the split with a BA mesh) and
  the pipelined loop turned off by the split.
"""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)
from test_torch_slice import small_cfg

import orb_slam2_ros2_tpu_torch.config as tcfg
from orb_slam2_ros2_tpu_torch.io.synthetic import SyntheticStereoDataset
from orb_slam2_ros2_tpu_torch.io.trajectory import ate_rmse
from orb_slam2_ros2_tpu_torch.pipeline.system import SLAM

N_FRAMES = 14
SPLIT = ("cpu", "cpu")


def split_cfg(split: bool, **dist) -> tcfg.SLAMConfig:
    """``tests/test_split_mode.py``'s configuration."""
    return tcfg.SLAMConfig(
        camera=tcfg.CameraConfig(fx=200.0, fy=200.0, cx=160.0, cy=96.0, baseline=0.5, width=320, height=192),
        orb=tcfg.ORBConfig(n_features=500, max_keypoints=512),
        tracking=tcfg.TrackingConfig(min_init_depth_kps=120, max_local_mappoints=4096, max_local_keyframes=16,
                                     min_localmap_matches=20, min_localmap_inliers=20),
        mapping=tcfg.MappingConfig(synchronous=False, force_ba_every=2),
        map=tcfg.MapConfig(max_keyframes=32, max_mappoints=8192, max_obs_per_mp=12),
        bow=tcfg.BoWConfig(branching=4, depth=2),
        ba=tcfg.BAConfig(pcg_iters=15),
        dist=tcfg.DistConfig(tracker_mapper_split=split, **dist),
    )


def localization_cfg(split: bool) -> tcfg.SLAMConfig:
    cfg = small_cfg(tcfg)
    return cfg.replace(dist=dataclasses.replace(cfg.dist, tracker_mapper_split=split))


WORLDS = {"mapping": (split_cfg, N_FRAMES, 0.55), "localization": (localization_cfg, 4, 0.35)}


@pytest.fixture(scope="module", params=sorted(WORLDS))
def runs(request):
    make_cfg, n_frames, speed = WORLDS[request.param]
    ds = SyntheticStereoDataset(make_cfg(False).camera, n_frames=n_frames, speed=speed, device="cpu")
    frames = [ds.frame(i) for i in range(n_frames)]
    out = {}
    for split in (False, True):
        slam = SLAM(make_cfg(split), enable_loop_closing=False, device="cpu",
                    devices=SPLIT if split else None)
        poses = []
        for i, (img_l, img_r, _) in enumerate(frames):
            pose, stats = slam.track(img_l, img_r)
            assert pose is not None, f"lost at {i} (split={split}): {stats}"
            poses.append(pose)
        slam.flush()
        out[split] = (poses, slam)
    return out, [g for _, _, g in frames]


def test_split_matches_single_device_trajectory(runs):
    out, gt = runs
    (est_s, slam_s), (est_p, slam_p) = out[False], out[True]
    assert slam_p._split and not slam_s._split
    for i, (a, b) in enumerate(zip(est_s, est_p)):
        np.testing.assert_allclose(a, b, atol=5e-4, err_msg=f"frame {i}")
    assert slam_p.n_keyframes == slam_s.n_keyframes
    ate = ate_rmse([np.linalg.inv(t) for t in est_p], gt)
    assert ate < 0.2, ate


def test_split_final_trajectory_and_view(runs):
    out, _ = runs
    est_p, slam = out[True]
    assert len(slam.final_trajectory()) == len(est_p)
    # the tracker reads its own copies of the map's tables
    view_pos, view_valid = slam._view
    assert view_pos.data_ptr() != slam.map.mp_pos.data_ptr()
    assert view_valid.data_ptr() != slam.map.mp_valid.data_ptr()
    assert slam.local.pos.data_ptr() != slam._local_map.pos.data_ptr()
    # ... refreshed after the last mapping event
    assert np.array_equal(view_pos.numpy(), slam.map.mp_pos.numpy())
    assert np.array_equal(view_valid.numpy(), slam.map.mp_valid.numpy())
    assert (slam.device, slam.map_device) == (torch.device("cpu"), torch.device("cpu"))


def test_split_refusals_and_pipelined_off():
    with pytest.raises(ValueError, match="≥2 devices"):
        SLAM(split_cfg(True), devices=("cpu",))
    with pytest.raises(ValueError, match="mutually exclusive"):
        SLAM(split_cfg(True, n_devices=2), devices=SPLIT)
    cfg = split_cfg(True)
    cfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking, pipelined=True))
    assert not SLAM(cfg, devices=SPLIT)._pipelined
    assert SLAM(split_cfg(False).replace(tracking=cfg.tracking), device="cpu")._pipelined
