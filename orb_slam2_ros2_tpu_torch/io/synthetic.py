"""Synthetic textured-box stereo world, rendered on the device (port of
``render``, ``trajectory``, ``circle_trajectory`` and
``SyntheticStereoDataset`` of ``orb_slam2_ros2_tpu/io/synthetic.py``).

Every pixel ray is intersected with the six planes of a closed box and
shaded with blocky 3-octave value noise, then blurred by a 5×5 σ=1 optical
PSF.  The lattice hash is uint32 arithmetic done in int64 with a 32-bit mask
after each step; like the JAX version's float→uint32 conversion, negative
lattice coordinates saturate at 0.

World frame: x right, y down, z forward.  Box: x ∈ [−8, 8], y ∈ [−3, 1.5],
z ∈ [−5, 200].
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..geometry import se3
from ..ops.pyramid import gaussian_blur

BOX_MIN = np.array([-8.0, -3.0, -5.0], np.float32)
BOX_MAX = np.array([8.0, 1.5, 200.0], np.float32)
_MASK32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a · b) mod 2³² for int64 ``a`` in [0, 2³²) without int64 overflow."""
    lo, hi = b & 0xFFFF, b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK32


def _hash3(ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor) -> torch.Tensor:
    """Integer lattice hash → [0, 1) f32 (floats saturate to [0, 2³²) first)."""
    def u32(v):
        return torch.clamp(v, 0.0, float(_MASK32)).to(torch.int64)

    h = (_mul32(u32(ix), 0x8DA6B343) + _mul32(u32(iy), 0xD8163841) + _mul32(u32(iz), 0xCB1AB31F)) & _MASK32
    h = h ^ (h >> 13)
    h = _mul32(h, 0x9E3779B1)
    h = h ^ (h >> 16)
    return (h & 0xFFFF).float() / 65536.0


def _texture(p: torch.Tensor) -> torch.Tensor:
    """Blocky 3-octave value noise in [0, 255] for world points [..., 3]."""
    out = 0.0
    amp = 1.0
    freq = 1.5
    total = 0.0
    for _ in range(3):
        q = torch.floor(p * freq)
        out = out + amp * _hash3(q[..., 0], q[..., 1], q[..., 2])
        total += amp
        amp *= 0.5
        freq *= 2.7
    return 255.0 * out / total


def render(K_inv: torch.Tensor, Twc: torch.Tensor, h: int, w: int,
           box_scale: float = 1.0, sky: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render (image [h, w] f32 in [0, 255], depth [h, w] f32 camera z) on
    the device of ``Twc``."""
    dev = Twc.device
    vs, us = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=dev),
        torch.arange(w, dtype=torch.float32, device=dev), indexing="ij",
    )
    pix = torch.stack([us, vs, torch.ones_like(us)], dim=-1)
    rays_c = torch.einsum("ij,hwj->hwi", K_inv, pix)
    R, t = se3.R_of(Twc), se3.t_of(Twc)
    rays_w = torch.einsum("ij,hwj->hwi", R, rays_c)
    origin = t

    sxy = np.array([box_scale, box_scale, 1.0], np.float32)
    bmin, bmax = BOX_MIN * sxy, BOX_MAX * sxy
    t_best = torch.full((h, w), float("inf"), device=dev)
    for axis in range(3):
        for bound in (bmin[axis], bmax[axis]):
            d = rays_w[..., axis]
            safe_d = torch.where(d.abs() > 1e-9, d, 1e-9)
            t_hit = (float(bound) - origin[axis]) / safe_d
            ok = t_hit > 1e-3
            t_best = torch.where(ok & (t_hit < t_best), t_hit, t_best)

    # XLA:CPU contracts the x and y hit coordinates into fused multiply-adds
    # and not z; the texture lattice has cell edges ON the x = 8 and z = 200
    # walls, so matching the reference renderer needs the same rounding
    # (an f32·f32 product is exact in f64, so one f64 add rounds like an fma)
    hit = torch.stack([
        (origin[0].double() + t_best.double() * rays_w[..., 0].double()).float(),
        (origin[1].double() + t_best.double() * rays_w[..., 1].double()).float(),
        origin[2] + t_best * rays_w[..., 2],
    ], dim=-1)
    img = _texture(hit)
    depth = t_best * rays_c[..., 2]
    if sky:
        far = (depth > 60.0) & (rays_w[..., 1] < 0.03)
        img = torch.where(far, 96.0 + 40.0 * vs / h, img)
    # optical PSF: real cameras never deliver razor-sharp block edges
    img = gaussian_blur(img, ksize=5, sigma=1.0)
    return img, depth


def circle_trajectory(n_frames: int, radius: float = 4.0, z_center: float = 15.0) -> np.ndarray:
    """Closed circular trajectory (camera yaws along the tangent)."""
    poses = []
    for i in range(n_frames):
        a = 2.0 * np.pi * i / (n_frames - 4)
        c, s = np.cos(a), np.sin(a)
        centre = np.array([radius * s, 0.0, z_center - radius * c], np.float32)
        cy, sy = np.cos(a), np.sin(a)
        R = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = centre
        poses.append(T)
    return np.stack(poses)


def trajectory(n_frames: int, speed: float = 0.8, yaw_rate: float = 0.002) -> np.ndarray:
    """Ground-truth Twc poses [n, 4, 4]: forward motion with gentle yaw."""
    poses = []
    T = np.eye(4, dtype=np.float32)
    for i in range(n_frames):
        poses.append(T.copy())
        yaw = yaw_rate * np.sin(i * 0.05)
        c, s = np.cos(yaw), np.sin(yaw)
        dR = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        step = np.eye(4, dtype=np.float32)
        step[:3, :3] = dR
        step[:3, 3] = [0.0, 0.0, speed]
        T = T @ step
    return np.stack(poses)


class SyntheticStereoDataset:
    """Synthetic stereo sequence with ground truth, rendered on ``device``
    (the role of the reference's KITTI driver, example/Stereo/KittiStereo.cc)."""

    def __init__(self, cam_cfg, n_frames: int = 100, speed: float = 0.8,
                 circle: bool = False, box_scale: float = 1.0,
                 sky: bool = False, *, device="cuda"):
        self.cfg = cam_cfg
        self.device = torch.device(device)
        self.poses_wc = circle_trajectory(n_frames) if circle else trajectory(n_frames, speed)
        K = np.array(
            [[cam_cfg.fx, 0, cam_cfg.cx], [0, cam_cfg.fy, cam_cfg.cy], [0, 0, 1]],
            np.float32,
        )
        self.K_inv = torch.from_numpy(np.linalg.inv(K)).to(self.device)
        self.n_frames = n_frames
        self.box_scale = box_scale
        self.sky = sky

    def __len__(self):
        return self.n_frames

    def frame(self, i: int):
        """Returns (img_left, img_right, Twc_gt): images [H, W] f32 tensors on
        the device, the pose a numpy array."""
        Twc = torch.from_numpy(self.poses_wc[i]).to(self.device)
        imgL, _ = render(self.K_inv, Twc, self.cfg.height, self.cfg.width, self.box_scale, self.sky)
        right_offset = torch.eye(4, device=self.device)
        right_offset[0, 3] = self.cfg.baseline
        imgR, _ = render(self.K_inv, Twc @ right_offset, self.cfg.height, self.cfg.width,
                         self.box_scale, self.sky)
        return imgL, imgR, np.asarray(self.poses_wc[i])

    def frame_with_depth(self, i: int):
        """Returns (img, depth, Twc_gt): the left image and its depth map
        (camera z in metres) of the default box, [H, W] f32 tensors on the
        device."""
        Twc = torch.from_numpy(self.poses_wc[i]).to(self.device)
        img, depth = render(self.K_inv, Twc, self.cfg.height, self.cfg.width)
        return img, depth, np.asarray(self.poses_wc[i])
