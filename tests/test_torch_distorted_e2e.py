"""The lens-distortion path of the port against the JAX package, on the CPU:
the counterpart of ``tests/test_distorted_e2e.py`` (``slow`` in JAX).

JAX's half-scale TUM fr2 camera (320×240, the five ``TUM2`` coefficients
verbatim) renders the pinhole world, and JAX's own ``_warp_to_distorted``
warps each frame into the lens once; the same numpy arrays go to both
packages.  JAX's accuracy gate at its 22 frames is
``tests/test_torch_distorted_accuracy.py`` (a file of its own: each file
runs on one test worker).

* The RGB-D frontend on a warped frame: the raw keypoints, their octaves and
  descriptors within the budgets of ``tests/test_torch_rgbd.py``, and on
  the keypoints both found the undistorted ``uv`` within 1e-3 px (eight f32
  fixed-point iterations of a strong lens, XLA:CPU's contraction against
  torch's), the same depth pixel read at the raw keypoint (within
  ``tests/test_torch_rgbd.py``'s 1e-5 relative) and ``right_u`` from the
  undistorted ``u``.
* Ten frames of ``SLAM(rgbd=True)`` on the warped frames in step with the
  JAX system: the same states, poses within 1 cm and 0.1° (the tolerance of
  ``tests/test_torch_rgbd.py``), the same keyframe count.
* ``chip_smoke.warp_to_distorted``, the warp the card runs, against JAX's
  on the CPU: depth exact, intensity within 1e-4 plus what the two
  undistortions' f32 difference (≤ 1e-4 px) moves it (the test says why).
"""

import numpy as np
import pytest
import torch
from test_distorted_e2e import TUM2, _cam_cfg, _warp_to_distorted
from test_torch_mapping import rot_deg
from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)

import jax
import jax.numpy as jnp

import chip_smoke
import orb_slam2_ros2_tpu.config as jcfg
import orb_slam2_ros2_tpu_torch.config as tcfg
from orb_slam2_ros2_tpu.features import extractor as jext
from orb_slam2_ros2_tpu.geometry.camera import CameraParams as JCam
from orb_slam2_ros2_tpu.geometry.camera import undistort_points as jundistort
from orb_slam2_ros2_tpu.io.synthetic import SyntheticStereoDataset as JDataset
from orb_slam2_ros2_tpu.pipeline.system import SLAM as JSLAM
from orb_slam2_ros2_tpu_torch.features import extractor as text
from orb_slam2_ros2_tpu_torch.geometry.camera import CameraParams as TCam
from orb_slam2_ros2_tpu_torch.geometry.camera import undistort_points as tundistort
from orb_slam2_ros2_tpu_torch.pipeline.system import SLAM as TSLAM

N_STEP = 10                # frames run in step with JAX
N_GATE = 22                # JAX's frames (tests/test_torch_distorted_accuracy.py)
SPEED = 0.35
POSE_TOL_M, POSE_TOL_DEG = 1e-2, 0.1
UV_TOL_PX = 1e-3


def dist_cfg(mod, distorted: bool = True):
    """``tests/test_distorted_e2e.py``'s configuration in either package."""
    kw = TUM2 if distorted else {}
    return mod.SLAMConfig(
        camera=mod.CameraConfig(fx=260.2, fy=260.3, cx=160.8, cy=124.6, baseline=0.5,
                                width=320, height=240, camera_type=1, depth_scale=1000.0, **kw),
        orb=mod.ORBConfig(n_features=600, max_keypoints=768),
        tracking=mod.TrackingConfig(min_init_depth_kps=100, max_local_mappoints=4096,
                                    max_local_keyframes=16),
        map=mod.MapConfig(max_keyframes=64, max_mappoints=16384, max_obs_per_mp=16),
    )


@pytest.fixture(scope="module")
def frames():
    """(pinhole image, pinhole depth in sensor units, warped image, warped
    depth in sensor units, Twc) per frame, as numpy, rendered and warped by
    the JAX package."""
    cam_cfg = _cam_cfg(True)
    assert dist_cfg(jcfg).camera == cam_cfg
    cam = JCam.from_config(cam_cfg)
    ds = JDataset(cam_cfg, n_frames=N_GATE, speed=SPEED)
    out = []
    for i in range(N_GATE):
        img, depth, Twc = ds.frame_with_depth(i)
        img_d, depth_d = _warp_to_distorted(cam, img, depth)
        s = cam_cfg.depth_scale
        out.append((np.array(img), np.array(depth * s), np.array(img_d), np.array(depth_d * s), np.asarray(Twc)))
    return out


def test_warp_matches_jax():
    """The two warps on one frame.  Both undistort the pixel grid by eight
    f32 fixed-point iterations, and XLA:CPU contracts them into FMAs where
    torch does not: the source coordinates differ by up to ~6e-5 px (on
    about half the pixels, most in the corners).  So the grids are held
    within 1e-4 px, depth (nearest) exactly, and intensity (bilinear)
    within 1e-4 grey levels plus what the grids' difference moves it across
    the render's steepest edge (255 grey levels a pixel): 1e-3 flat fails at
    ~0.02% of the pixels, by up to ~2e-3 at ~140 grey levels."""
    cam_cfg = _cam_cfg(True)
    ds = JDataset(cam_cfg, n_frames=N_GATE, speed=SPEED)
    img, depth, _ = ds.frame_with_depth(5)
    jcam, tcam = JCam.from_config(cam_cfg), TCam.from_config(dist_cfg(tcfg).camera, "cpu")
    want_img, want_dep = (np.asarray(x) for x in _warp_to_distorted(jcam, img, depth))
    got_img, got_dep = chip_smoke.warp_to_distorted(tcam, torch.from_numpy(np.array(img)),
                                                    torch.from_numpy(np.array(depth)))
    H, W = want_img.shape
    vv, uu = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32), indexing="ij")
    grid = np.stack([uu.reshape(-1), vv.reshape(-1)], axis=-1)
    src_j = np.asarray(jax.jit(jundistort)(jcam, jnp.asarray(grid)))
    src_t = tundistort(tcam, torch.from_numpy(grid)).numpy()
    gap = np.abs(src_t - src_j).sum(axis=1).reshape(H, W)
    assert gap.max() <= 1e-4, gap.max()
    np.testing.assert_array_equal(got_dep.numpy(), want_dep)
    assert (np.abs(got_img.numpy() - want_img) <= 1e-4 + 255.0 * gap).all()
    # the lens moves the corners' content by pixels (inwards: this lens
    # leaves no black border)
    assert np.abs(src_j - grid).max() > 5.0 and (want_img > 0).all()


def test_distorted_rgbd_frontend_matches_jax(frames):
    _, _, img, depth, _ = frames[1]
    cfg_j, cfg_t = dist_cfg(jcfg), dist_cfg(tcfg)
    assert cfg_t.camera.has_distortion and text._extract_kw(cfg_t)["undistort"]
    sj = jext.make_rgbd_frontend(cfg_j)(jnp.asarray(img), jnp.asarray(depth), JCam.from_config(cfg_j.camera))
    st = text.make_rgbd_frontend(cfg_t, "cpu")(torch.from_numpy(img), torch.from_numpy(depth),
                                               TCam.from_config(cfg_t.camera, "cpu"))
    fj, ft = sj.feats, st.feats
    same_kp = (np.all(ft.uv_raw.numpy() == np.asarray(fj.uv_raw), axis=1)
               & (ft.valid.numpy() == np.asarray(fj.valid)))
    assert same_kp.mean() >= 0.97, same_kp.mean()
    both = same_kp & np.asarray(fj.valid)
    assert both.sum() > 300
    np.testing.assert_array_equal(ft.octave.numpy()[both], np.asarray(fj.octave)[both])
    desc_same = np.all(ft.desc.numpy().view(np.uint32)[both] == np.asarray(fj.desc)[both], axis=1)
    assert desc_same.mean() >= 0.97, desc_same.mean()
    # the lens moved the keypoints, and both packages undistort alike
    uv_t, uv_j = ft.uv.numpy()[both], np.asarray(fj.uv)[both]
    assert np.abs(uv_t - ft.uv_raw.numpy()[both]).max() > 2.0
    np.testing.assert_allclose(uv_t, uv_j, atol=UV_TOL_PX, rtol=0)
    # depth at the raw keypoint, right_u from the undistorted u
    np.testing.assert_array_equal(st.depth.numpy()[both] > 0, np.asarray(sj.depth)[both] > 0)
    np.testing.assert_allclose(st.depth.numpy()[both], np.asarray(sj.depth)[both], rtol=1e-5)
    ok = both & (np.asarray(sj.depth) > 0)
    assert ok.sum() > 300
    np.testing.assert_allclose(st.right_u.numpy()[ok], np.asarray(sj.right_u)[ok], atol=UV_TOL_PX, rtol=0)
    bf = cfg_t.camera.bf
    np.testing.assert_allclose(st.right_u.numpy()[ok], uv_t[ok[both]][:, 0] - bf / st.depth.numpy()[ok],
                               atol=1e-4, rtol=0)


def _run(slam, frames, distorted: bool, n: int, jax_side: bool = False) -> tuple:
    states, poses = [], []
    for img, depth, img_d, depth_d, _ in frames[:n]:
        a, b = (img_d, depth_d) if distorted else (img, depth)
        pose, stats = slam.track(jnp.asarray(a), jnp.asarray(b)) if jax_side else slam.track(a, b)
        states.append(slam.state.name)
        poses.append(None if pose is None else np.asarray(pose))
    slam.flush()
    return states, poses


def test_distorted_slam_in_step_with_jax(frames):
    sj, pj = _run(JSLAM(dist_cfg(jcfg), rgbd=True, enable_loop_closing=False), frames, True, N_STEP, True)
    slam_t = TSLAM(dist_cfg(tcfg), rgbd=True, enable_loop_closing=False, device="cpu")
    st, pt = _run(slam_t, frames, True, N_STEP)
    assert st == sj == ["OK"] * N_STEP
    Pj, Pt = np.stack(pj), np.stack(pt)
    assert np.abs(Pt[:, :3, 3] - Pj[:, :3, 3]).max() <= POSE_TOL_M
    assert rot_deg(Pj, Pt).max() <= POSE_TOL_DEG
    assert slam_t.n_keyframes >= 2
    gt = np.stack([np.linalg.inv(f[4]) for f in frames[:N_STEP]])
    assert np.abs(Pt[:, :3, 3] - gt[:, :3, 3]).max() < 0.1
