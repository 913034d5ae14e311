"""The pipelined loop through a blackout and a relocalization, against the
JAX package's, on the CPU (the third case of ``tests/test_pipelined.py``,
with fewer frames).

Both systems map 10 frames rendered by the JAX package at 0.4 m/frame with
loop closing on (its keyframe database is what relocalization queries; the
vocabulary is trained on keyframe 0 by both, identically), then see three
blank frames, then frames 4-9 again.  The pipelined loop finds the loss one
frame late, abandons its speculative frame, relocalizes and tracks on.  The
relocalization bar is lowered to 20 inliers as in the JAX test (this world
cannot reach 50).  Checks: the loss is seen, the same TrackState after every
call, the same calls returning a pose and relocalizing, the same frames in
``trajectory`` with every pose within 1 cm / 0.1°, and at least three of the
last six frames tracked.
"""

import numpy as np
import pytest
from test_torch_mapping import rot_deg, two_torch_threads  # noqa: F401  (autouse)
from test_torch_pipelined import POSE_TOL_DEG, POSE_TOL_M, pipe_cfg, render

import orb_slam2_ros2_tpu.config as jcfg
import orb_slam2_ros2_tpu_torch.config as tcfg
from orb_slam2_ros2_tpu.pipeline import system as jsys
from orb_slam2_ros2_tpu_torch.pipeline import system as tsys

N_FRAMES = 19
BLANK = range(10, 13)
REVISIT_FROM = 4


def plan():
    seq = render(10, 0.4)
    blank = np.zeros_like(seq[0][0])
    out = []
    for i in range(N_FRAMES):
        if i < BLANK.start:
            out.append(seq[i][:2])
        elif i in BLANK:
            out.append((blank, blank.copy()))
        else:
            out.append(seq[REVISIT_FROM + (i - BLANK.stop) % 6][:2])
    return out


def run(slam, frames) -> dict:
    out = dict(states=[], returned=[], reloc=[])
    for img_l, img_r in frames:
        pose, stats = slam.track(img_l, img_r)
        out["states"].append(slam.state.name)
        out["returned"].append(pose is not None)
        out["reloc"].append(bool(stats.get("relocalized")))
    slam.flush()
    out["traj"] = list(slam.trajectory)
    return out


@pytest.fixture(scope="module")
def runs():
    frames = plan()
    return dict(
        jax=run(jsys.SLAM(pipe_cfg(jcfg, min_localmap_inliers_reloc=20), enable_loop_closing=True), frames),
        torch=run(tsys.SLAM(pipe_cfg(tcfg, min_localmap_inliers_reloc=20), enable_loop_closing=True,
                            device="cpu"), frames),
    )


def test_blackout_is_lost_and_relocalized_as_jax(runs):
    j, t = runs["jax"], runs["torch"]
    assert "LOST" in t["states"] and any(t["reloc"])
    assert t["states"] == j["states"]
    assert t["returned"] == j["returned"] and t["reloc"] == j["reloc"]
    late = [f for f, _ in t["traj"] if f >= N_FRAMES - 6]
    assert len(late) >= 3, f"no recovery after the blackout: {late}"


def test_blackout_trajectory_matches_jax(runs):
    j, t = runs["jax"]["traj"], runs["torch"]["traj"]
    assert [f for f, _ in t] == [f for f, _ in j]
    assert [f for f, _ in t] == sorted(f for f, _ in t)
    Pj, Pt = np.stack([T for _, T in j]), np.stack([T for _, T in t])
    assert np.abs(Pj[:, :3, 3] - Pt[:, :3, 3]).max() <= POSE_TOL_M
    assert rot_deg(Pj, Pt).max() <= POSE_TOL_DEG
