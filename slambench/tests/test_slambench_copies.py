"""The benchmark's frozen copies held to the port's originals, at a small
size on the CPU: the renderer and routes (``io/synthetic.py``), the lens
warp (``chip_smoke.warp_to_distorted``), the ATE arithmetic
(``io/trajectory.py``), the kernels' work counts (``chip_smoke.py``), the
percentile (``tools/bench_full.py``) and the plain frontend reference
(``features/extractor.py`` and ``ops/``).

Run from the repository's root: ``python -m pytest slambench/tests -q``."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from orb_slam2_ros2_tpu_torch.config import CameraConfig, MatcherConfig, ORBConfig, SLAMConfig
from orb_slam2_ros2_tpu_torch.features.extractor import make_rgbd_frontend, make_stereo_frontend
from orb_slam2_ros2_tpu_torch.geometry.camera import CameraParams
from orb_slam2_ros2_tpu_torch.io import synthetic, trajectory as port_traj
from orb_slam2_ros2_tpu_torch.ops import fast
from orb_slam2_ros2_tpu_torch.ops.canvas import canvas_layout, padded_canvas_shape
from orb_slam2_ros2_tpu_torch.tools import bench_full
from slambench import roofline, timing
from slambench.gen import lens, routes, world
from slambench.reference import frontend, trajectory

H, W = 96, 160
K = np.array([[120.0, 0, 80.0], [0, 120.0, 48.0], [0, 0, 1]], np.float32)
K_INV = torch.from_numpy(np.linalg.inv(K))


def _poses(n=3):
    return routes.drive(n, speed_m=0.7)


@pytest.mark.parametrize("box_scale,sky", [(1.0, False), (2.5, True)])
def test_render_equals_the_original(box_scale, sky):
    T = _poses()
    ours, depth = world.render(K_INV, torch.from_numpy(T), H, W, box_scale=box_scale, sky=sky)
    for i in range(len(T)):
        img, dep = synthetic.render(K_INV, torch.from_numpy(T[i]), H, W, box_scale, sky)
        assert (ours[i] - img).abs().max() <= 1e-3
        assert torch.allclose(depth[i], dep, rtol=1e-6, atol=1e-5)


def test_texture_shift_moves_the_world():
    T = torch.from_numpy(_poses(1))
    a, _ = world.render(K_INV, T, H, W)
    b, _ = world.render(K_INV, T, H, W, tex_offset=(0.0, 0.0, 137.0))
    assert (a - b).abs().mean() > 5.0


def test_drive_equals_the_original():
    np.testing.assert_array_equal(routes.drive(40, speed_m=0.8, yaw_rate_rad=0.002),
                                  synthetic.trajectory(40, 0.8, 0.002))


def test_circuits_close_each_circle():
    r = dict(speed_m=0.8, turn_speed_m=0.8, radius_m=15.0, first_straight_m=40.0, straight_m=48.0,
             start=(-15.0, 0.0, 0.0))
    T = routes.circuits(500, **r)
    n_turn = int(round(2 * np.pi * 15.0 / 0.8))
    for e in (50, 50 + n_turn + 60):       # 40 m, then 48 m of straight at 0.8 m a frame
        back = e + n_turn
        assert np.abs(T[back][:3, 3] - T[e][:3, 3]).max() < 1e-3
        assert np.abs(T[back][:3, :3] - T[e][:3, :3]).max() < 1e-4


def test_warp_equals_chip_smoke():
    cfg = CameraConfig(fx=110.0, fy=110.5, cx=80.2, cy=48.1, k1=0.231222, k2=-0.784899, p1=-0.003257,
                       p2=-0.000105, k3=0.917205, width=W, height=H)
    cam = CameraParams.from_config(cfg, "cpu")
    img, depth = world.render(K_INV, torch.from_numpy(_poses(2)), H, W)
    ours_i, ours_d = lens.warp_to_distorted(lens.camera_tensors(dataclasses.asdict(cfg), "cpu"), img, depth)
    for i in range(2):
        ref_i, ref_d = chip_smoke.warp_to_distorted(cam, img[i], depth[i])
        torch.testing.assert_close(ours_i[i], ref_i, rtol=0, atol=0)
        torch.testing.assert_close(ours_d[i], ref_d, rtol=0, atol=0)


def test_ate_and_percentile_equal_the_originals():
    rng = np.random.default_rng(3)
    gt = routes.drive(20, speed_m=0.5)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(scale=0.05, size=(20, 3))
    assert trajectory.ate_rmse(est, gt) == port_traj.ate_rmse(est, gt)
    pct, ate, path = trajectory.ate_pct_of_path([(i, np.linalg.inv(T)) for i, T in enumerate(est)], gt)
    assert ate == pytest.approx(port_traj.ate_rmse(est, gt), rel=1e-6)   # Tcw → Twc in f64
    assert path == pytest.approx(0.5 * 19, rel=1e-5) and pct == pytest.approx(100 * ate / path)
    vals = rng.random(57).tolist()
    assert timing.percentile(vals, 95) == bench_full.pct(vals, 95)


def test_kernel_work_equals_chip_smoke():
    cfg = SLAMConfig()
    o, c = cfg.orb, cfg.camera
    row_off, _, shapes = canvas_layout(c.height, c.width, o.n_levels, o.scale_factor)
    rows_p, cols_p = padded_canvas_shape(c.height, c.width, o.n_levels, o.scale_factor)
    table = fast.pyramid_table(tuple(row_off.tolist()), tuple(shapes), 2, rows_p, cols_p)
    bound_ms, _ = chip_smoke.k1_bound_ms(table)
    assert roofline.least_seconds(roofline.k1_work(shapes, 2)) * 1e3 == pytest.approx(bound_ms, rel=1e-12)
    canvas = torch.zeros((2 * rows_p, cols_p), dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    centers = torch.from_numpy(np.stack([rng.integers(0, 2 * rows_p, 500), rng.integers(0, cols_p, 500)], 1))
    rows, cols = chip_smoke.k2_windows(canvas, centers)
    k2_ms, _ = chip_smoke.k2_bound_ms(canvas, rows, cols)
    ours = roofline.least_seconds(roofline.k2_work(canvas.shape, centers.numpy())) * 1e3
    assert ours == pytest.approx(k2_ms, rel=1e-12)


def _small_cfg(**camera):
    cam = dict(fx=120.0, fy=120.0, cx=80.0, cy=48.0, baseline=0.5, width=W, height=H, **camera)
    return SLAMConfig(camera=CameraConfig(**cam), orb=ORBConfig(n_features=300, max_keypoints=320),
                      matcher=MatcherConfig())


def _section(cfg):
    return {f.name: dataclasses.asdict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}


def _same(port_feats, ref, names=("uv", "octave", "desc", "valid")):
    for n in names:
        assert torch.equal(getattr(port_feats, n), ref[n]), n


def test_reference_frontend_equals_the_stereo_frontend():
    cfg = _small_cfg()
    T = torch.from_numpy(_poses(1))
    left, _ = world.render(K_INV, T, H, W)
    right, _ = world.render(K_INV, T @ torch.tensor([[1, 0, 0, 0.5], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1.0]]),
                            H, W)
    a, b = left[0].round().clamp(0, 255), right[0].round().clamp(0, 255)
    port = make_stereo_frontend(cfg, "cpu")(a, b, CameraParams.from_config(cfg.camera, "cpu"))
    ref = frontend.frontend(a, b, _section(cfg), rgbd=False)
    _same(port.feats, ref)
    assert int(port.feats.valid.sum()) > 100
    assert torch.equal(port.right_u, ref["right_u"]) and torch.equal(port.depth, ref["depth"])
    assert int((ref["depth"] > 0).sum()) > 30


def test_reference_frontend_equals_the_rgbd_frontend_with_a_lens():
    cfg = _small_cfg(k1=0.231222, k2=-0.784899, p1=-0.003257, p2=-0.000105, k3=0.917205, camera_type=1,
                     color=1, depth_scale=5208.0)
    img, depth = world.render(K_INV, torch.from_numpy(_poses(1)), H, W)
    img, depth = lens.warp_to_distorted(lens.camera_tensors(dataclasses.asdict(cfg.camera), "cpu"), img,
                                        depth * 0.15 * 5208.0)
    a, b = img[0].round().clamp(0, 255), depth[0].round().clamp(0, 65535)
    port = make_rgbd_frontend(cfg, "cpu")(a, b, CameraParams.from_config(cfg.camera, "cpu"))
    ref = frontend.frontend(a, b, _section(cfg), rgbd=True)
    _same(port.feats, ref)
    assert torch.equal(port.right_u, ref["right_u"]) and torch.equal(port.depth, ref["depth"])


def test_fp8_control_moves_the_frontend():
    cfg = _small_cfg()
    a, _ = world.render(K_INV, torch.from_numpy(_poses(1)), H, W)
    a = a[0].round().clamp(0, 255)
    ref = frontend.frontend(a, a, _section(cfg), rgbd=False)
    low = frontend.frontend(a, a, _section(cfg), rgbd=False, precision="fp8")
    moved = (ref["valid"] != low["valid"]) | ((ref["uv"] - low["uv"]).abs().amax(-1) > 0)
    assert float(moved.float().mean()) > 0.3
