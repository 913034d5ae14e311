"""End-to-end parity of the port's full SLAM without loop closing with the
JAX package's in the synchronous mapping mode (``mapping.synchronous``: the
local BA and keyframe cull run right after each keyframe's front half), on
the CPU.  The frames, configuration and checks of
``tests/test_torch_mapping_slice.py``, which runs the deferred-tail mode;
here the JAX system runs its own fused keyframe programs, and both systems
keep the default capacities.
"""

import pytest
from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)
from test_torch_mapping_slice import RUN_CHECKS, render, run, slice_cfg

import orb_slam2_ros2_tpu.config as jcfg
import orb_slam2_ros2_tpu_torch.config as tcfg
from orb_slam2_ros2_tpu.pipeline.system import SLAM as JSLAM
from orb_slam2_ros2_tpu_torch.pipeline.system import SLAM as TSLAM


@pytest.fixture(scope="module")
def runs():
    frames = render()
    return dict(
        jax=run(JSLAM(slice_cfg(jcfg, synchronous=True), enable_loop_closing=False), frames),
        torch=run(TSLAM(slice_cfg(tcfg, synchronous=True), enable_loop_closing=False, device="cpu"),
                  frames),
    )


@pytest.mark.parametrize("check", list(RUN_CHECKS))
def test_synchronous_mapping_matches_jax(runs, check):
    RUN_CHECKS[check](runs["jax"], runs["torch"])


def test_every_keyframe_ran_its_tail(runs):
    """In the synchronous mode no tail is left pending between frames."""
    assert runs["torch"]["slam"]._pending_kf is None
    assert runs["torch"]["slam"]._tail_counter == sum(runs["torch"]["kf"][1:])
