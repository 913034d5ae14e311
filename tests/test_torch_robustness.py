"""Robustness of the port against the JAX package, on the CPU: the
counterparts of ``tests/test_outlier_robustness.py`` and of
``tests/test_slam_e2e.py::test_tracking_robust_to_image_noise`` (both
``slow`` in JAX).

* The monster outlier: JAX's problem (200 stereo observations of a 1241×376
  camera, 0.3 px noise, one point at the camera plane that projects through
  the z-clamp to ~1e8 px) goes through both packages' ``optimize_pose``.  The
  port meets JAX's gates (translation error under 2 cm, more than 90% of the
  observations inliers, the monster rejected), its inlier mask equals JAX's
  and its pose agrees with JAX's within 1e-4 m and 1e-3°: two f32 LMs of
  40 steps over the same inputs, whose sums differ in order only.
* Image noise: i.i.d. Gaussian noise of σ = 6 grey levels
  (``default_rng(42)``, both images, drawn in JAX's order) on ten frames of
  ``entry_config()``'s 320×192 world at 0.35 m/frame.  The same noisy
  arrays go to both packages' ``SLAM``.  The port meets JAX's gates (≥ 90%
  of the frames tracked, ATE under 8% of the path), tracks the frames JAX
  tracks, and its poses agree with JAX's within 1 cm and 0.1°, the
  tolerance of ``tests/test_torch_rgbd.py``: the noise is the same array in
  both, so the packages differ as on clean frames (the bf16 pyramid's
  one-ulp differences).
"""

import jax.numpy as jnp
import numpy as np
import torch
from test_torch_mapping import rot_deg
from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)

import orb_slam2_ros2_tpu.config as jcfg
import orb_slam2_ros2_tpu_torch.config as tcfg
from orb_slam2_ros2_tpu.geometry import se3 as jse3
from orb_slam2_ros2_tpu.geometry.camera import CameraParams as JCam
from orb_slam2_ros2_tpu.geometry.camera import project as jproject
from orb_slam2_ros2_tpu.io.synthetic import SyntheticStereoDataset as JDataset
from orb_slam2_ros2_tpu.io.trajectory import ate_rmse
from orb_slam2_ros2_tpu.pipeline.system import SLAM as JSLAM
from orb_slam2_ros2_tpu.solvers import pose_opt as jpose
from orb_slam2_ros2_tpu_torch.entry import entry_config
from orb_slam2_ros2_tpu_torch.geometry.camera import CameraParams as TCam
from orb_slam2_ros2_tpu_torch.pipeline.system import SLAM as TSLAM
from orb_slam2_ros2_tpu_torch.solvers import pose_opt as tpose

POSE_TOL_M, POSE_TOL_DEG = 1e-4, 1e-3          # the monster problem, f32 against f32
SLAM_TOL_M, SLAM_TOL_DEG = 1e-2, 0.1           # tests/test_torch_rgbd.py
NOISE_SIGMA, NOISE_FRAMES, NOISE_SPEED = 6.0, 10, 0.35


def monster_problem():
    """``tests/test_outlier_robustness.py``'s observations, built by the JAX
    package as that test builds them: (camera config, PoseObs as numpy,
    T0, the true Tcw)."""
    r = np.random.default_rng(0)
    cam = JCam.from_config(jcfg.CameraConfig())
    n = 200
    Tcw_gt = jse3.exp(jnp.asarray([0.1, -0.05, 0.3, 0.02, -0.03, 0.01], jnp.float32))
    pw = np.stack([r.uniform(-10, 10, n), r.uniform(-3, 3, n), r.uniform(5, 40, n)], 1).astype(np.float32)
    pc = jse3.apply(Tcw_gt, jnp.asarray(pw))
    uv, _ = jproject(cam, pc)
    uv = np.array(uv) + r.normal(0, 0.3, (n, 2)).astype(np.float32)
    pw[0] = np.asarray(jse3.apply(jse3.inverse(Tcw_gt), jnp.asarray([[0.5, 0.2, 1e-5]]))[0])
    z = np.asarray(pc[:, 2])
    right_u = (uv[:, 0] - float(cam.bf) / np.maximum(z, 0.1)).astype(np.float32)
    obs = dict(pw=pw, uv=uv.astype(np.float32), right_u=right_u, inv_sigma2=np.ones(n, np.float32),
               is_stereo=np.ones(n, bool), valid=np.ones(n, bool))
    T0 = jse3.exp(jnp.asarray([0.05, 0.02, -0.03, 0.01, 0.0, -0.01], jnp.float32)) @ Tcw_gt
    return obs, np.array(T0), np.array(Tcw_gt)


def test_monster_outlier_does_not_capture_pose():
    obs, T0, Tcw_gt = monster_problem()
    n = obs["valid"].shape[0]
    Tj, in_j, n_j = jpose.optimize_pose(JCam.from_config(jcfg.CameraConfig()), jnp.asarray(T0),
                                        jpose.PoseObs(**{k: jnp.asarray(v) for k, v in obs.items()}))
    Tt, in_t, n_t = tpose.optimize_pose(TCam.from_config(tcfg.CameraConfig(), "cpu"), torch.from_numpy(T0),
                                        tpose.PoseObs(**{k: torch.from_numpy(v) for k, v in obs.items()}))
    Tt, in_t = Tt.numpy(), in_t.numpy()
    # JAX's gates, on the port
    err = Tt @ np.linalg.inv(Tcw_gt)
    assert np.linalg.norm(err[:3, 3]) < 0.02, err
    assert int(n_t) > 0.9 * n and not in_t[0]
    # and the port against JAX
    np.testing.assert_array_equal(in_t, np.asarray(in_j))
    assert int(n_t) == int(n_j)
    assert np.abs(Tt[:3, 3] - np.asarray(Tj)[:3, 3]).max() <= POSE_TOL_M
    assert rot_deg(Tt[None], np.asarray(Tj)[None]).max() <= POSE_TOL_DEG


def noise_cfg(mod):
    """``entry_config()`` in either package."""
    c = entry_config()
    return mod.SLAMConfig(
        camera=mod.CameraConfig(fx=c.camera.fx, fy=c.camera.fy, cx=c.camera.cx, cy=c.camera.cy,
                                baseline=c.camera.baseline, width=c.camera.width, height=c.camera.height),
        orb=mod.ORBConfig(n_features=c.orb.n_features, max_keypoints=c.orb.max_keypoints),
        tracking=mod.TrackingConfig(min_init_depth_kps=c.tracking.min_init_depth_kps,
                                    max_local_mappoints=c.tracking.max_local_mappoints,
                                    max_local_keyframes=c.tracking.max_local_keyframes),
        map=mod.MapConfig(max_keyframes=c.map.max_keyframes, max_mappoints=c.map.max_mappoints,
                          max_obs_per_mp=c.map.max_obs_per_mp),
    )


def noisy_frames():
    """Ten frames of the world with JAX's noise: (left, right, Twc) as numpy."""
    rng = np.random.default_rng(42)
    ds = JDataset(noise_cfg(jcfg).camera, n_frames=NOISE_FRAMES, speed=NOISE_SPEED)
    out = []
    for i in range(NOISE_FRAMES):
        img_l, img_r, Twc = ds.frame(i)
        n_l = np.asarray(img_l) + rng.normal(0, NOISE_SIGMA, img_l.shape).astype(np.float32)
        n_r = np.asarray(img_r) + rng.normal(0, NOISE_SIGMA, img_r.shape).astype(np.float32)
        out.append((n_l.astype(np.float32), n_r.astype(np.float32), np.asarray(Twc)))
    return out


def test_tracking_robust_to_image_noise_matches_jax():
    assert noise_cfg(tcfg) == entry_config()
    frames = noisy_frames()
    runs = {}
    for name, slam in (("jax", JSLAM(noise_cfg(jcfg))), ("torch", TSLAM(noise_cfg(tcfg), device="cpu"))):
        poses = []
        for img_l, img_r, _ in frames:
            a, b = (jnp.asarray(img_l), jnp.asarray(img_r)) if name == "jax" else (img_l, img_r)
            pose, _ = slam.track(a, b)
            poses.append(None if pose is None else np.asarray(pose))
        runs[name] = poses
    pj, pt = runs["jax"], runs["torch"]
    tracked = [i for i, p in enumerate(pt) if p is not None]
    # JAX's gates, on the port
    assert len(tracked) >= 0.9 * NOISE_FRAMES, f"tracked only {len(tracked)}/{NOISE_FRAMES} noisy frames"
    ate = ate_rmse([np.linalg.inv(pt[i]) for i in tracked], [frames[i][2] for i in tracked])
    assert ate < 0.08 * NOISE_FRAMES * NOISE_SPEED, f"noisy ATE {ate:.3f} m"
    # and the port against JAX
    assert tracked == [i for i, p in enumerate(pj) if p is not None]
    Pj, Pt = np.stack([pj[i] for i in tracked]), np.stack([pt[i] for i in tracked])
    assert np.abs(Pt[:, :3, 3] - Pj[:, :3, 3]).max() <= SLAM_TOL_M
    assert rot_deg(Pj, Pt).max() <= SLAM_TOL_DEG
