"""Batched pinhole camera model (port of ``orb_slam2_ros2_tpu/geometry/camera.py``).

- ``project``:    camera-frame 3D → pixel (u, v)      (reference Camera.cc:15-24)
- ``project_stereo``: ``project`` plus the right-image u (Frame.cc:125-159)
- ``unproject``:  pixel + depth → camera-frame 3D     (Frame.cc:262-275)
- ``undistort_points``: fixed-iteration 5-parameter radial-tangential
  undistortion replacing ``cv::undistortPoints`` (Camera.cc:31-43);
  ``distort_points`` is the forward model.

Intrinsics live as 0-d tensors on the camera's device, so no call copies
from the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import CameraConfig


class CameraParams(NamedTuple):
    """Device-resident intrinsics."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    dist: torch.Tensor  # [5] = (k1, k2, p1, p2, k3)
    bf: torch.Tensor    # baseline * fx

    @staticmethod
    def from_config(cfg: CameraConfig, device) -> "CameraParams":
        def f(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        return CameraParams(
            fx=f(cfg.fx), fy=f(cfg.fy), cx=f(cfg.cx), cy=f(cfg.cy),
            dist=f([cfg.k1, cfg.k2, cfg.p1, cfg.p2, cfg.k3]), bf=f(cfg.bf),
        )

    @property
    def K(self) -> torch.Tensor:
        """The 3×3 intrinsic matrix."""
        z = torch.zeros_like(self.fx)
        o = torch.ones_like(self.fx)
        return torch.stack([
            torch.stack([self.fx, z, self.cx]),
            torch.stack([z, self.fy, self.cy]),
            torch.stack([z, z, o]),
        ])


def project(cam: CameraParams, pc: torch.Tensor, eps: float = 1e-6):
    """Camera-frame points [..., 3] → pixels [..., 2] and validity mask
    (points at or behind the camera plane are invalid)."""
    z = pc[..., 2]
    valid = z > eps
    zs = torch.where(valid, z, 1.0)
    u = cam.fx * pc[..., 0] / zs + cam.cx
    v = cam.fy * pc[..., 1] / zs + cam.cy
    return torch.stack([u, v], dim=-1), valid


def project_stereo(cam: CameraParams, pc: torch.Tensor, eps: float = 1e-6):
    """``project`` and the right-image u coordinate ``uR = u − bf/z``."""
    uv, valid = project(cam, pc, eps)
    zs = torch.where(valid, pc[..., 2], 1.0)
    return uv, uv[..., 0] - cam.bf / zs, valid


def unproject(cam: CameraParams, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Pixels [..., 2] + depth [...] → camera-frame points [..., 3]."""
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def _distort_normalized(cam: CameraParams, xy: torch.Tensor) -> torch.Tensor:
    k1, k2, p1, p2, k3 = (cam.dist[i] for i in range(5))
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_points(cam: CameraParams, uv: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Undistort pixel keypoints [..., 2] → ideal pixel coords by a fixed
    number of fixed-point iterations."""
    x0 = (uv[..., 0] - cam.cx) / cam.fx
    y0 = (uv[..., 1] - cam.cy) / cam.fy
    xy0 = torch.stack([x0, y0], dim=-1)
    xy = xy0
    for _ in range(iters):
        xy = xy0 - (_distort_normalized(cam, xy) - xy)
    u = xy[..., 0] * cam.fx + cam.cx
    v = xy[..., 1] * cam.fy + cam.cy
    return torch.stack([u, v], dim=-1)


def distort_points(cam: CameraParams, uv: torch.Tensor) -> torch.Tensor:
    """Forward distortion of ideal pixel coords [..., 2] (synthetic data and
    tests)."""
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    xy = _distort_normalized(cam, torch.stack([x, y], dim=-1))
    return torch.stack([xy[..., 0] * cam.fx + cam.cx, xy[..., 1] * cam.fy + cam.cy], dim=-1)
