"""JAX's accuracy gate of ``tests/test_distorted_e2e.py`` on the port, at
JAX's 22 frames, on the CPU: ``SLAM(rgbd=True)`` on the pinhole frames and
on the frames JAX's ``_warp_to_distorted`` warped into the half-scale TUM
fr2 lens (``tests/test_torch_distorted_e2e.py``'s fixture), every frame
``OK``, the distorted ATE under max(2.5 × the pinhole run's, 3% of the
path), more than 300 map points."""

import numpy as np
from test_torch_distorted_e2e import N_GATE, SPEED, _run, dist_cfg, frames  # noqa: F401  (fixture)
from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)

import orb_slam2_ros2_tpu_torch.config as tcfg
from orb_slam2_ros2_tpu.io.trajectory import ate_rmse
from orb_slam2_ros2_tpu_torch.pipeline.system import SLAM as TSLAM


def test_distorted_matches_pinhole_accuracy(frames):  # noqa: F811
    ates, slams = {}, {}
    for distorted in (False, True):
        slam = TSLAM(dist_cfg(tcfg, distorted), rgbd=True, enable_loop_closing=False, device="cpu")
        states, poses = _run(slam, frames, distorted, N_GATE)
        assert states == ["OK"] * N_GATE, (distorted, states)
        ates[distorted] = ate_rmse([np.linalg.inv(p) for p in poses], [f[4] for f in frames])
        slams[distorted] = slam
    path = N_GATE * SPEED
    assert ates[True] < max(2.5 * ates[False], 0.03 * path), ates
    assert slams[True].n_mappoints > 300
