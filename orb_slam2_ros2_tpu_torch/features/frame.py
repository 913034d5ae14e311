"""Frame data model: fixed-capacity struct-of-arrays NamedTuples of tensors
(port of ``orb_slam2_ros2_tpu/features/frame.py``; reference
include/ORB_SLAM2/Frame.h:22-331)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class FrameFeatures(NamedTuple):
    """One image's extracted features, padded to a static capacity N.

    ``uv`` are level-0 undistorted pixel coords; ``uv_raw`` keeps the
    detector coords for patch sampling on the raw pyramid.
    """

    uv: torch.Tensor        # f32[N, 2]
    uv_raw: torch.Tensor    # f32[N, 2]
    octave: torch.Tensor    # i32[N]
    response: torch.Tensor  # f32[N]
    angle: torch.Tensor     # f32[N] degrees [0, 360)
    desc: torch.Tensor      # i32[N, 8] (the bits of the JAX package's uint32 words)
    valid: torch.Tensor     # bool[N]

    @property
    def capacity(self) -> int:
        return self.uv.shape[0]


class StereoFrame(NamedTuple):
    """Left features + per-keypoint stereo match: ``right_u`` (−1 when
    unmatched) and ``depth`` = bf / disparity (−1 when unmatched)."""

    feats: FrameFeatures
    right_u: torch.Tensor   # f32[N]
    depth: torch.Tensor     # f32[N]
