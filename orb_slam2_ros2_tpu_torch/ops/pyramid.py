"""Image pyramid construction (port of ``orb_slam2_ros2_tpu/ops/pyramid.py``).

An 8-level ×1.2 pyramid (reference: src/ORBExtractor.cc:278-320) in bf16,
every level resized directly from level 0 by INTER_AREA box-weight matmuls:
one shared column resize, then one row matmul per level.  The numpy weight
builders are copies of the JAX package's (tested equal).

The JAX version multiplies bf16 operands with f32 accumulation; here the
bf16-rounded operands are upcast and multiplied in f32, then rounded to bf16
where JAX rounds (levels agree within one bf16 ulp: summation order differs).
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def level_shapes(h: int, w: int, n_levels: int, scale_factor: float) -> List[Tuple[int, int]]:
    """Static per-level (H, W), mirroring cv::resize rounding (ORBExtractor.cc:287)."""
    out = []
    for l in range(n_levels):
        inv = 1.0 / (scale_factor ** l)
        out.append((int(round(h * inv)), int(round(w * inv))))
    return out


def _gaussian_kernel_1d(ksize: int = 7, sigma: float = 2.0) -> np.ndarray:
    x = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur with edge replication, [H, W] f32, as shifted
    weighted sums (rows first, then columns)."""
    k = [float(v) for v in _gaussian_kernel_1d(ksize, sigma)]
    pad = ksize // 2
    h, w = img.shape
    x = F.pad(img[None, None], (0, 0, pad, pad), mode="replicate")[0, 0]
    x = sum(k[i] * x[i:i + h, :] for i in range(ksize))
    x = F.pad(x[None, None], (pad, pad, 0, 0), mode="replicate")[0, 0]
    return sum(k[i] * x[:, i:i + w] for i in range(ksize))


@lru_cache(maxsize=None)
def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] f32 bilinear resampling matrix with half-pixel centres:
    output pixel i samples input coordinate (i + 0.5)·n_in/n_out − 0.5."""
    scale = n_in / n_out
    x = (np.arange(n_out) + 0.5) * scale - 0.5
    x0 = np.floor(x).astype(np.int64)
    frac = (x - x0).astype(np.float32)
    lo = np.clip(x0, 0, n_in - 1)
    hi = np.clip(x0 + 1, 0, n_in - 1)
    W = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    np.add.at(W, (rows, lo), 1.0 - frac)
    np.add.at(W, (rows, hi), frac)
    return W


def resize_bilinear_matmul(img: torch.Tensor, h_out: int, w_out: int) -> torch.Tensor:
    """Bilinear resize of ``[..., H, W]`` by two weight-matrix products (rows,
    then columns).  The weights are rounded to the input dtype, each product
    is taken in f32 and rounded to the input dtype once, as the JAX version's
    ``preferred_element_type=f32`` then ``astype`` does."""
    h_in, w_in = img.shape[-2:]
    dt = img.dtype
    Wh = torch.from_numpy(_resize_weights(h_in, h_out)).to(img.device).to(dt).float()
    Ww = torch.from_numpy(_resize_weights(w_in, w_out)).to(img.device).to(dt).float()
    tmp = torch.matmul(Wh, img.float()).to(dt)
    return torch.matmul(tmp.float(), Ww.T).to(dt)


@lru_cache(maxsize=None)
def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] f32 box-average (cv INTER_AREA) resampling matrix:
    output pixel i averages the input span [i·s, (i+1)·s), s = n_in/n_out."""
    s = n_in / n_out
    W = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        lo, hi = i * s, (i + 1) * s
        j0, j1 = int(np.floor(lo)), int(np.ceil(hi))
        for j in range(j0, min(j1, n_in)):
            W[i, j] = (min(j + 1.0, hi) - max(float(j), lo)) / s
    return W


@lru_cache(maxsize=None)
def _pyramid_block_weights(h: int, w: int, n_levels: int, scale_factor: float):
    """``Ww_all [w, ΣWl]`` (levels 1.. stacked along columns) for one shared
    column resize, the per-level row operators ``Wh_l [Hl, h]``, and the
    column offsets."""
    shapes = level_shapes(h, w, n_levels, scale_factor)[1:]
    Ww_all = np.concatenate([_area_weights(w, wl).T for _, wl in shapes], axis=1)
    Wh_per = tuple(_area_weights(h, hl) for hl, _ in shapes)
    w_off = np.cumsum([0] + [wl for _, wl in shapes])
    return Wh_per, Ww_all, tuple(w_off.tolist())


class PyramidWeights(NamedTuple):
    """The resize operators on a device, bf16-rounded and held as f32."""

    Ww: torch.Tensor               # [w, ΣWl]
    Wh: Tuple[torch.Tensor, ...]   # per level ≥ 1: [Hl, h]
    w_off: Tuple[int, ...]


def _bf16_f32(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a).to(device).to(torch.bfloat16).float()


def pyramid_weights(h: int, w: int, n_levels: int, scale_factor: float, device) -> PyramidWeights:
    Wh_per, Ww_np, w_off = _pyramid_block_weights(h, w, n_levels, scale_factor)
    return PyramidWeights(
        Ww=_bf16_f32(Ww_np, device),
        Wh=tuple(_bf16_f32(W, device) for W in Wh_per),
        w_off=w_off,
    )


def build_pyramid(img: torch.Tensor, n_levels: int = 8, scale_factor: float = 1.2,
                  weights: PyramidWeights | None = None):
    """[..., H, W] f32 → tuple of bf16 [..., Hl, Wl] levels (leading dims batch).

    ``weights`` are the device-resident operators of ``pyramid_weights``;
    built here (a host copy) when not given.
    """
    h, w = img.shape[-2:]
    x = img.to(torch.bfloat16)
    if n_levels == 1:
        return (x,)
    if weights is None:
        weights = pyramid_weights(h, w, n_levels, scale_factor, img.device)
    cols = torch.matmul(x.float(), weights.Ww).to(torch.bfloat16)
    shapes = level_shapes(h, w, n_levels, scale_factor)
    levels = [x]
    for l in range(1, n_levels):
        hl, wl = shapes[l]
        c0 = weights.w_off[l - 1]
        col_l = cols[..., c0:c0 + wl].float()
        levels.append(torch.matmul(weights.Wh[l - 1], col_l).to(torch.bfloat16))
    return tuple(levels)
