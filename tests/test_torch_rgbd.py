"""Parity of the port's RGB-D path with the JAX package, on the CPU.

One frame rendered by the JAX package (320×192, image + depth map in sensor
units) goes through ``make_rgbd_frontend`` of both packages: the keypoint,
descriptor and depth budgets are those of the stereo frontend test
(``tests/test_torch_frontend.py``: the pyramid's one-ulp differences may move
a few corners), and on the keypoints both found ``right_u`` and ``depth``
agree to 1e-5 relative.  The one-image FAST level table is checked on the
host as ``tests/test_torch_fast_pyramid.py`` checks the stereo one.  Then ten
frames of ``SLAM(rgbd=True)`` run in step with the JAX system: the same
states, poses within 1 cm and 0.1°.
"""

import numpy as np
import pytest
import torch
from test_torch_fast_pyramid import _tile_cover
from test_torch_mapping import rot_deg
from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)

import jax
import jax.numpy as jnp

import orb_slam2_ros2_tpu.config as jcfg
import orb_slam2_ros2_tpu_torch.config as tcfg
from orb_slam2_ros2_tpu.features import extractor as jext
from orb_slam2_ros2_tpu.geometry.camera import CameraParams as JCam
from orb_slam2_ros2_tpu.io.synthetic import SyntheticStereoDataset as JDataset
from orb_slam2_ros2_tpu.pipeline.system import SLAM as JSLAM
from orb_slam2_ros2_tpu_torch.errors import ImageSizeError
from orb_slam2_ros2_tpu_torch.features import extractor as text
from orb_slam2_ros2_tpu_torch.geometry.camera import CameraParams as TCam
from orb_slam2_ros2_tpu_torch.io.synthetic import SyntheticStereoDataset as TDataset
from orb_slam2_ros2_tpu_torch.ops import fast as tfast
from orb_slam2_ros2_tpu_torch.pipeline.system import SLAM as TSLAM

N_FRAMES = 10


def rgbd_cfg(mod, **camera):
    """The configuration of ``tests/test_rgbd.py``."""
    return mod.SLAMConfig(
        camera=mod.CameraConfig(**{**dict(fx=200.0, fy=200.0, cx=160.0, cy=96.0, baseline=0.5,
                                          width=320, height=192, camera_type=1, depth_scale=1000.0),
                                   **camera}),
        orb=mod.ORBConfig(n_features=600, max_keypoints=768),
        tracking=mod.TrackingConfig(min_init_depth_kps=120, max_local_mappoints=4096,
                                    max_local_keyframes=16),
        map=mod.MapConfig(max_keyframes=64, max_mappoints=16384, max_obs_per_mp=16),
    )


@pytest.fixture(scope="module")
def frames():
    """(image, depth map in sensor units, Twc) per frame, as numpy."""
    cfg = rgbd_cfg(jcfg)
    ds = JDataset(cfg.camera, n_frames=N_FRAMES, speed=0.35)
    out = []
    for i in range(N_FRAMES):
        img, depth, Twc = ds.frame_with_depth(i)
        out.append((np.array(img), np.array(depth * cfg.camera.depth_scale), Twc))
    return out


def test_frame_with_depth_matches_jax(frames):
    ds = TDataset(rgbd_cfg(tcfg).camera, n_frames=N_FRAMES, speed=0.35, device="cpu")
    img, depth, Twc = ds.frame_with_depth(3)
    np.testing.assert_allclose(img.numpy(), frames[3][0], atol=1e-3)
    np.testing.assert_allclose(depth.numpy() * 1000.0, frames[3][1], rtol=1e-5)
    np.testing.assert_array_equal(Twc, frames[3][2])


def test_rgbd_frontend_matches_jax(frames):
    img, depth, _ = frames[1]
    cfg_j, cfg_t = rgbd_cfg(jcfg), rgbd_cfg(tcfg)
    sj = jax.tree.map(np.asarray, jext.make_rgbd_frontend(cfg_j)(
        jnp.asarray(img), jnp.asarray(depth), JCam.from_config(cfg_j.camera)))
    fe = text.make_rgbd_frontend(cfg_t, "cpu")
    assert isinstance(fe, text.RGBDFrontend) and fe.consts.fast_table.batch == 1
    st = fe(torch.from_numpy(img), torch.from_numpy(depth), TCam.from_config(cfg_t.camera, "cpu"))
    fj, ft = sj.feats, st.feats
    assert ft.uv.shape == (768, 2) and st.depth.shape == (768,)
    same_kp = np.all(ft.uv.numpy() == fj.uv, axis=1) & (ft.valid.numpy() == fj.valid)
    assert same_kp.mean() >= 0.97, same_kp.mean()
    both = same_kp & fj.valid
    assert both.sum() > 300
    np.testing.assert_array_equal(ft.octave.numpy()[both], fj.octave[both])
    desc_same = np.all(ft.desc.numpy().view(np.uint32)[both] == fj.desc[both], axis=1)
    assert desc_same.mean() >= 0.97, desc_same.mean()
    # the same keypoint reads the same depth pixel
    np.testing.assert_array_equal(st.depth.numpy()[both] > 0, sj.depth[both] > 0)
    np.testing.assert_allclose(st.depth.numpy()[both], sj.depth[both], rtol=1e-5)
    np.testing.assert_allclose(st.right_u.numpy()[both], sj.right_u[both], rtol=1e-5, atol=1e-4)
    assert (sj.depth[both] > 0).mean() > 0.9
    assert (st.depth.numpy()[~ft.valid.numpy()] == -1).all()


def test_rgbd_frontend_depth_holes_and_colour(frames):
    """Zero depth (a sensor hole) leaves a keypoint without depth; an RGB
    image is reduced to grey on the device as in the stereo frontend."""
    img, depth, _ = frames[1]
    cfg = rgbd_cfg(tcfg, color=1)
    cam = TCam.from_config(cfg.camera, "cpu")
    fe = text.make_rgbd_frontend(cfg, "cpu")
    holes = depth.copy()
    holes[:, :160] = 0.0
    rgb = np.repeat(img[:, :, None], 3, axis=2)
    st = fe(torch.from_numpy(rgb), torch.from_numpy(holes), cam)
    ref = text.make_rgbd_frontend(rgbd_cfg(tcfg), "cpu")(torch.from_numpy(img), torch.from_numpy(depth), cam)
    left = st.feats.uv_raw[:, 0].round() < 160
    assert (st.feats.uv - ref.feats.uv).abs().max() < 1e-3
    assert (st.depth[left & st.feats.valid] == -1).all() and (st.right_u[left] == -1).all()
    assert torch.equal(st.depth[~left], ref.depth[~left])


@pytest.mark.parametrize("case", ["tum", "small"])
def test_one_image_level_table_covers_every_pixel_once(case):
    """The FAST level table of a one-image canvas (what ``frontend_constants``
    builds for RGB-D): every pixel of every level written by exactly one
    tile, the levels inside the canvas, rows not shared."""
    cfg = rgbd_cfg(tcfg, width=640, height=480) if case == "tum" else rgbd_cfg(tcfg)
    consts = text.frontend_constants(cfg, "cpu", n_images=1)
    table = consts.fast_table
    assert table.batch == 1 and len(table.segs) == cfg.orb.n_levels
    for c in _tile_cover(table):
        assert (c == 1).all()
    rows, cols = table.canvas_shape
    used = np.zeros(rows, np.int32)
    for row_base, h, w, tiles_x, _, _ in table.segs:
        assert tiles_x == -(-w // tfast.TILE_W) and w <= cols and row_base + h <= rows
        used[row_base:row_base + h] += 1
    assert used.max() == 1
    assert sum(h * w for _, h, w, *_ in table.segs) == table.out_numel
    assert text.frontend_constants(cfg, "cpu").fast_table.batch == 2
    with pytest.raises(ValueError):  # a stereo table refuses one image
        text.extract_features_batch(torch.zeros((1, cfg.camera.height, cfg.camera.width)),
                                    None, text.frontend_constants(cfg, "cpu"), **text.StereoFrontend(cfg, "cpu").kw)


@pytest.fixture(scope="module")
def runs(frames):
    out = {}
    for name, slam in (("jax", JSLAM(rgbd_cfg(jcfg), rgbd=True, enable_loop_closing=False)),
                       ("torch", TSLAM(rgbd_cfg(tcfg), rgbd=True, enable_loop_closing=False, device="cpu"))):
        states, poses, stats = [], [], []
        for img, depth, _ in frames:
            pose, st = slam.track(img, depth if name == "torch" else jnp.asarray(depth))
            states.append(slam.state.name)
            poses.append(pose)
            stats.append(st)
        slam.flush()
        out[name] = (states, poses, stats, slam)
    return out


def test_rgbd_slam_in_step_with_jax(runs, frames):
    (sj, pj, _, slam_j), (st, pt, _, slam_t) = runs["jax"], runs["torch"]
    assert st == sj == ["OK"] * N_FRAMES
    Pj, Pt = np.stack(pj), np.stack(pt)
    assert np.abs(Pt[:, :3, 3] - Pj[:, :3, 3]).max() <= 1e-2
    assert rot_deg(Pj, Pt).max() <= 0.1
    assert slam_t.n_keyframes == slam_j.n_keyframes >= 2
    assert abs(slam_t.n_mappoints - slam_j.n_mappoints) <= 0.03 * slam_j.n_mappoints
    # and both follow the ground truth
    gt = np.stack([np.linalg.inv(f[2]) for f in frames])
    assert np.abs(Pt[:, :3, 3] - gt[:, :3, 3]).max() < 0.1


def test_rgbd_refuses_colour_depth_and_names_it(frames):
    img, depth, _ = frames[0]
    slam = TSLAM(rgbd_cfg(tcfg, color=1), rgbd=True, enable_loop_closing=False, device="cpu")
    with pytest.raises(ImageSizeError, match="depth image"):
        slam.track(np.repeat(img[:, :, None], 3, 2), np.repeat(depth[:, :, None], 3, 2))
    with pytest.raises(ImageSizeError, match="depth image"):
        slam.track(img, depth[:100])
    pose, stats = slam.track(np.repeat(img[:, :, None], 3, 2), depth)
    assert pose is not None and stats["initialized"]
