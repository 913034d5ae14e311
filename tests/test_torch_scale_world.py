"""The scale run's world at the reference's radius, on the CPU: both
packages lose track where the camera leaves the world's box.

``bench_scale_run.py`` drives a 30 m circle around (0, 0, 40), 800 frames a
lap, through the KITTI-like world whose box spans x ∈ [−20, 20] m; at lap
angle a the camera stands at x = 30 sin a.  Both packages' ``SLAM`` (the
scale run's keyframing at 320×192) are fed the same frames rendered by the
JAX package, from frame 80 (x = 17.6 m) to frame 100 (x = 21.2 m): each
tracks every frame until the camera is within 1 m of the box's wall, loses
track there within two frames of the other (0.24 m of path a frame), and
does not track again before frame 100.  So the frames the port's
``scale_run`` loses at its default radius are the world's, not the port's.
"""

import dataclasses as dc

import numpy as np
from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)

import orb_slam2_ros2_tpu.config as jcfg
import orb_slam2_ros2_tpu_torch.config as tcfg
from orb_slam2_ros2_tpu.io.synthetic import SyntheticStereoDataset, multi_lap_circle_trajectory
from orb_slam2_ros2_tpu.pipeline.system import SLAM as JSLAM
from orb_slam2_ros2_tpu_torch.pipeline.system import SLAM as TSLAM
from orb_slam2_ros2_tpu_torch.scale_run import scale_config

START, END, LAP, RADIUS, BOX_X = 80, 100, 800, 30.0, 20.0
WALL_M, MAX_FRAMES_APART = 1.0, 2


def small(mod):
    return mod.SLAMConfig(
        camera=mod.CameraConfig(fx=200.0, fy=200.0, cx=160.0, cy=96.0, baseline=0.5, width=320, height=192),
        orb=mod.ORBConfig(n_features=1000, max_keypoints=1024),
        tracking=mod.TrackingConfig(min_init_depth_kps=60, max_local_mappoints=4096, max_local_keyframes=16),
        bow=mod.BoWConfig(branching=4, depth=2), ba=mod.BAConfig(pcg_iters=15))


def jax_scale_config(cfg):
    """``scale_config`` on the JAX side (``bench_scale_run.py:51-75``), with
    the port's test capacity."""
    return cfg.replace(
        tracking=dc.replace(cfg.tracking, th_depth=160.0, ref_ratio_th=1e9, min_frames=2, max_frames=5),
        map=jcfg.MapConfig(max_keyframes=64, max_mappoints=1 << 15, max_obs_per_mp=24, auto_grow=True))


def test_both_packages_lose_the_reference_scale_world_at_the_box_wall():
    jc = jax_scale_config(small(jcfg))
    ds = SyntheticStereoDataset(jc.camera, n_frames=4, speed=0.8, box_scale=2.5, sky=True)
    ds.poses_wc = multi_lap_circle_trajectory(END, frames_per_lap=LAP, radius=RADIUS, z_center=40.0)[START:]
    frames = [tuple(np.asarray(x) for x in ds.frame(i)) for i in range(END - START)]
    first_lost = {}
    for name, slam in (("jax", JSLAM(jc)), ("torch", TSLAM(scale_config(small(tcfg), 64), device="cpu"))):
        posed = [slam.track(img_l, img_r)[0] is not None for img_l, img_r, _ in frames]
        k = posed.index(False) if False in posed else len(posed)
        assert k < len(posed) and not any(posed[k:]), f"{name}: posed {posed}"
        first_lost[name] = START + k
    for name, f in first_lost.items():
        x = RADIUS * np.sin(2 * np.pi * f / LAP)
        assert abs(x - BOX_X) <= WALL_M, f"{name} lost at frame {f}, the camera at x = {x:.2f} m"
    assert abs(first_lost["jax"] - first_lost["torch"]) <= MAX_FRAMES_APART, first_lost
