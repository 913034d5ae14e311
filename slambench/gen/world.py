"""The textured-box world, rendered on the device in batches: a frozen copy
of ``orb_slam2_ros2_tpu_torch/io/synthetic.py``'s ``render`` with two
parameters of its own, the box's extent along z (so that a drive can outlast
the window) and an offset that shifts the texture lattice (a seed's world).
With ``z_range=(-5, 200)`` and a zero offset it renders what the original
renders, frame for frame (``tests/test_slambench_gen.py``).

Every pixel ray is intersected with the six planes of a closed box and
shaded with blocky 3-octave value noise, then blurred by a 5×5 σ=1 optical
PSF.  World frame: x right, y down, z forward.  Box: x ∈ [−8, 8]·s,
y ∈ [−3, 1.5]·s, z ∈ ``z_range``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

BOX_MIN_XY = np.array([-8.0, -3.0], np.float32)
BOX_MAX_XY = np.array([8.0, 1.5], np.float32)
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


def _gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    x = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, ksize: int = 5, sigma: float = 1.0) -> torch.Tensor:
    """Separable Gaussian blur with edge replication over the last two axes
    of ``[..., H, W]`` f32, as shifted weighted sums (rows, then columns)."""
    k = [float(v) for v in _gaussian_kernel_1d(ksize, sigma)]
    pad = ksize // 2
    h, w = img.shape[-2:]
    lead = img.shape[:-2]
    x = F.pad(img.reshape(-1, 1, h, w), (0, 0, pad, pad), mode="replicate")[:, 0]
    x = sum(k[i] * x[:, i:i + h, :] for i in range(ksize))
    x = F.pad(x[:, None], (pad, pad, 0, 0), mode="replicate")[:, 0]
    return sum(k[i] * x[:, :, i:i + w] for i in range(ksize)).reshape(*lead, h, w)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·b + c rounded once, as a fused multiply-add (an f32·f32 product is
    exact in f64, so one f64 add rounds as the fma does)."""
    return (a.double() * b.double() + c.double()).float()


def render(K_inv: torch.Tensor, Twc: torch.Tensor, h: int, w: int, *, box_scale: float = 1.0,
           z_range=(-5.0, 200.0), sky: bool = False, tex_offset=(0.0, 0.0, 0.0)):
    """Render a batch of cameras ``Twc [B, 4, 4]`` (f32, on the device):
    (images [B, h, w] f32 in [0, 255], depth [B, h, w] f32 camera z)."""
    dev = Twc.device
    vs, us = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    pix = torch.stack([us, vs, torch.ones_like(us)], dim=-1)
    rays_c = torch.einsum("ij,hwj->hwi", K_inv, pix)                     # [h, w, 3]
    R, origin = Twc[:, :3, :3], Twc[:, :3, 3]                            # [B, 3, 3], [B, 3]
    rays_w = torch.einsum("bij,hwj->bhwi", R, rays_c)                    # [B, h, w, 3]
    bmin = [float(v) for v in BOX_MIN_XY * box_scale] + [float(z_range[0])]
    bmax = [float(v) for v in BOX_MAX_XY * box_scale] + [float(z_range[1])]
    o = origin[:, None, None, :]                                         # [B, 1, 1, 3]
    t_best = torch.full(rays_w.shape[:3], float("inf"), device=dev)
    for axis in range(3):
        for bound in (bmin[axis], bmax[axis]):
            d = rays_w[..., axis]
            safe_d = torch.where(d.abs() > 1e-9, d, 1e-9)
            t_hit = (bound - o[..., axis]) / safe_d
            ok = t_hit > 1e-3
            t_best = torch.where(ok & (t_hit < t_best), t_hit, t_best)
    # XLA:CPU contracts the x and y coordinates into fused multiply-adds and
    # not z (the original renderer matches that rounding; the lattice has
    # cell edges on the x = 8 and z = 200 walls)
    hit = torch.stack([
        _fma(t_best, rays_w[..., 0], o[..., 0]),
        _fma(t_best, rays_w[..., 1], o[..., 1]),
        o[..., 2] + t_best * rays_w[..., 2],
    ], dim=-1)
    if any(tex_offset):
        hit = hit + torch.tensor(tex_offset, dtype=torch.float32, device=dev)
    img = _texture(hit)
    depth = t_best * rays_c[..., 2]
    if sky:
        far = (depth > 60.0) & (rays_w[..., 1] < 0.03)
        img = torch.where(far, 96.0 + 40.0 * vs / h, img)
    return gaussian_blur(img, ksize=5, sigma=1.0), depth
