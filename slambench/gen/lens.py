"""A pinhole render warped into a distorted camera's image plane: a frozen
copy of ``chip_smoke.warp_to_distorted`` and of the fixed-point
undistortion it uses (``geometry/camera.py`` ``undistort_points``), batched
over frames.  The distorted image at pixel u_d shows the pinhole content at
u_p = undistort(u_d): intensity bilinear, depth nearest (an interpolated
depth across a discontinuity invents 3D points), zero where u_p leaves the
image."""

from __future__ import annotations

import torch


def _distort_normalized(dist, xy: torch.Tensor) -> torch.Tensor:
    k1, k2, p1, p2, k3 = (dist[i] for i in range(5))
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_points(cam: dict, uv: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Distorted pixel coords [..., 2] → ideal pixel coords, by ``iters``
    fixed-point iterations; ``cam`` holds f32 0-d tensors fx, fy, cx, cy and
    ``dist`` [5] = (k1, k2, p1, p2, k3)."""
    x0 = (uv[..., 0] - cam["cx"]) / cam["fx"]
    y0 = (uv[..., 1] - cam["cy"]) / cam["fy"]
    xy0 = torch.stack([x0, y0], dim=-1)
    xy = xy0
    for _ in range(iters):
        xy = xy0 - (_distort_normalized(cam["dist"], xy) - xy)
    return torch.stack([xy[..., 0] * cam["fx"] + cam["cx"], xy[..., 1] * cam["fy"] + cam["cy"]], dim=-1)


def camera_tensors(camera: dict, device) -> dict:
    """The intrinsics of a configuration's ``camera`` section as f32 tensors."""
    def f(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    return dict(fx=f(camera["fx"]), fy=f(camera["fy"]), cx=f(camera["cx"]), cy=f(camera["cy"]),
                dist=f([camera.get(k, 0.0) for k in ("k1", "k2", "p1", "p2", "k3")]))


def warp_to_distorted(cam: dict, img: torch.Tensor, depth: torch.Tensor):
    """``img`` and ``depth`` [B, H, W] on ``cam``'s device → the same frames
    as the distorted camera sees them."""
    B, H, W = img.shape
    vv, uu = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=img.device),
                            torch.arange(W, dtype=torch.float32, device=img.device), indexing="ij")
    src = undistort_points(cam, torch.stack([uu.reshape(-1), vv.reshape(-1)], dim=-1))
    x, y = src[:, 0], src[:, 1]
    inb = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    # out-of-image (and diverged, non-finite) sources are masked; clamp their
    # indices into the image first
    xc = torch.nan_to_num(x, nan=0.0).clamp(-1.0, float(W))
    yc = torch.nan_to_num(y, nan=0.0).clamp(-1.0, float(H))
    x0 = torch.floor(xc).long().clamp(0, W - 2)
    y0 = torch.floor(yc).long().clamp(0, H - 2)
    fx_ = (x - x0).clamp(0.0, 1.0)
    fy_ = (y - y0).clamp(0.0, 1.0)
    i00, i01 = img[:, y0, x0], img[:, y0, x0 + 1]
    i10, i11 = img[:, y0 + 1, x0], img[:, y0 + 1, x0 + 1]
    val = (1 - fy_) * ((1 - fx_) * i00 + fx_ * i01) + fy_ * ((1 - fx_) * i10 + fx_ * i11)
    img_d = torch.where(inb, val, 0.0).reshape(B, H, W)
    xn = torch.round(xc).long().clamp(0, W - 1)
    yn = torch.round(yc).long().clamp(0, H - 1)
    dep = torch.where(inb, depth[:, yn, xn], 0.0).reshape(B, H, W)
    return img_d, dep
