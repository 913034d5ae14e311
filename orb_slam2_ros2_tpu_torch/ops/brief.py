"""Oriented-BRIEF description (port of ``orb_slam2_ros2_tpu/ops/brief.py``).

Grey-centroid orientation, then a 256-pair template rotated to one of 32
angle bins, with the 7×7 pre-compare Gaussian blur folded into one sampling
matrix (reference: src/ORBExtractor.cc:465-487, :427-456).  The numpy
builders of the template, the rotated-offset LUT and the pair-difference
matrix are copies of the JAX package's (tested equal).

Descriptors are int32 [N, 8]: the bits of the JAX package's uint32 words,
reinterpreted (torch has no shifts on uint32).

``set_template_file`` makes a file-loaded template the process-wide default
of ``brief_template`` and of every table derived from it (tests and simple
scripts; a frontend binds ``orb.brief_template_path`` per instance instead,
and keeps the sampling matrix it was built with).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from .patches import CENTER as PATCH_CENTER
from .patches import PATCH_COLS, PATCH_ROWS

N_PAIRS = 256
N_ANGLE_BINS = 32
PATCH_HALF = PATCH_CENTER  # keypoint border requirement (rows above/left)
TEMPLATE_CLIP = 13       # max |coordinate| of a template point pre-rotation
ORIENT_RADIUS = 15       # grey-centroid circular patch radius (ORBExtractor.cc:518)
BLUR_PAD = 3             # 7-tap Gaussian apron

_TEMPLATE_OVERRIDE = None  # set by set_template_file()


def load_template_file(path: str) -> np.ndarray:
    """Parse a BRIEF point-pair template in the reference's
    ``brief_template.txt`` format (reference ORBExtractor.cc:242-267).
    Returns int32 [256, 4]; short files pad with (0,0,0,0)."""
    import os

    if not os.path.exists(path):
        from ..errors import FileNotOpenError

        raise FileNotOpenError(f"BRIEF template file not found: {path}")
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 4:
                continue
            try:
                rows.append([float(v) for v in parts[:4]])
            except ValueError:
                continue  # header line
    if not rows:
        raise ValueError(f"BRIEF template file {path!r} contains no point pairs")
    t = np.round(np.asarray(rows))
    if np.abs(t).max() > TEMPLATE_CLIP:
        raise ValueError(
            f"template reach {np.abs(t).max():.0f} exceeds the supported "
            f"±{TEMPLATE_CLIP} (45×45 patch budget)"
        )
    t = t.astype(np.int32)
    if t.shape[0] < N_PAIRS:
        t = np.concatenate([t, np.zeros((N_PAIRS - t.shape[0], 4), np.int32)])
    return t[:N_PAIRS]


def _clear_template_caches() -> None:
    brief_template.cache_clear()
    rotated_offset_lut.cache_clear()
    _pair_difference_matrix.cache_clear()


def set_template_file(path: str) -> None:
    """Make a file-loaded template the process-wide default: what
    ``brief_template``, ``rotated_offset_lut`` and ``_pair_difference_matrix``
    return from now on (their caches are cleared)."""
    global _TEMPLATE_OVERRIDE
    _TEMPLATE_OVERRIDE = load_template_file(path)
    _clear_template_caches()


def clear_template_override() -> None:
    """Back to the seeded template."""
    global _TEMPLATE_OVERRIDE
    _TEMPLATE_OVERRIDE = None
    _clear_template_caches()


@lru_cache(maxsize=None)
def brief_template(seed: int = 17) -> np.ndarray:
    """[256, 4] int32 (x1, y1, x2, y2): seeded Gaussian pairs, BRIEF-style
    (or the file-loaded override, see ``set_template_file``)."""
    if _TEMPLATE_OVERRIDE is not None:
        return _TEMPLATE_OVERRIDE
    r = np.random.default_rng(seed)
    t = r.normal(scale=TEMPLATE_CLIP / 2.0, size=(N_PAIRS, 4))
    return np.clip(np.round(t), -TEMPLATE_CLIP, TEMPLATE_CLIP).astype(np.int32)


@lru_cache(maxsize=None)
def rotated_offset_lut(seed: int = 17) -> np.ndarray:
    """[N_ANGLE_BINS, 512] int32 flat indices into a 48×64 patch: row b holds
    the template rotated by 2πb/N_ANGLE_BINS, first points then second points."""
    return _lut_from_template(brief_template(seed))


def _lut_from_template(tpl: np.ndarray) -> np.ndarray:
    tpl = tpl.astype(np.float64)
    out = np.zeros((N_ANGLE_BINS, 2 * N_PAIRS), np.int32)
    for b in range(N_ANGLE_BINS):
        th = 2.0 * np.pi * b / N_ANGLE_BINS
        c, s = np.cos(th), np.sin(th)
        for half, sl in ((tpl[:, 0:2], slice(0, N_PAIRS)), (tpl[:, 2:4], slice(N_PAIRS, 2 * N_PAIRS))):
            x, y = half[:, 0], half[:, 1]
            xr = np.round(c * x - s * y).astype(np.int32)
            yr = np.round(s * x + c * y).astype(np.int32)
            out[b, sl] = (yr + PATCH_CENTER) * PATCH_COLS + (xr + PATCH_CENTER)
    return out


@lru_cache(maxsize=None)
def _moment_weights():
    """Circular-mask coordinate weights for the grey-centroid over the 48×64
    patch (centre at (22, 22)), flattened."""
    ys, xs = np.mgrid[0:PATCH_ROWS, 0:PATCH_COLS]
    ys = ys - PATCH_CENTER
    xs = xs - PATCH_CENTER
    mask = (xs * xs + ys * ys) <= ORIENT_RADIUS * ORIENT_RADIUS
    wx = (xs * mask).astype(np.float32).reshape(-1)
    wy = (ys * mask).astype(np.float32).reshape(-1)
    return wx, wy


def blur_patches(patches: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian over patch stacks [N, P, Q] as shifted weighted sums
    (rows first, then columns), edges replicated."""
    from .pyramid import _gaussian_kernel_1d

    k = [float(v) for v in _gaussian_kernel_1d(ksize, sigma)]
    pad = ksize // 2
    _, p, q = patches.shape
    x = F.pad(patches[:, None], (0, 0, pad, pad), mode="replicate")[:, 0]
    x = sum(k[i] * x[:, i:i + p, :] for i in range(ksize))
    x = F.pad(x[:, None], (pad, pad, 0, 0), mode="replicate")[:, 0]
    return sum(k[i] * x[:, :, i:i + q] for i in range(ksize))


@lru_cache(maxsize=None)
def _pair_difference_matrix(seed: int = 17):
    """[patch_px, N_ANGLE_BINS·N_PAIRS] f32 oriented-BRIEF sampling pattern
    with the pre-compare Gaussian blur folded in (+G7 at each pair's second
    point, −G7 at its first)."""
    return _pair_matrix_from_lut(rotated_offset_lut(seed))


_PAIR_MATRIX_CACHE: dict = {}


def pair_matrix_for_template(tpl: np.ndarray) -> np.ndarray:
    """Folded-blur sampling matrix for an explicit template array."""
    key = tpl.tobytes()
    if key not in _PAIR_MATRIX_CACHE:
        _PAIR_MATRIX_CACHE[key] = _pair_matrix_from_lut(_lut_from_template(tpl))
    return _PAIR_MATRIX_CACHE[key]


def _pair_matrix_from_lut(lut: np.ndarray) -> np.ndarray:
    from .pyramid import _gaussian_kernel_1d

    P = PATCH_ROWS * PATCH_COLS
    k1 = _gaussian_kernel_1d(7, 2.0).astype(np.float64)
    g7 = np.outer(k1, k1)  # [7, 7]
    D = np.zeros((P, N_ANGLE_BINS * N_PAIRS), np.float32)

    def stamp(col, flat_idx, sign):
        y, x = divmod(int(flat_idx), PATCH_COLS)
        D[
            (np.arange(y - 3, y + 4)[:, None] * PATCH_COLS
             + np.arange(x - 3, x + 4)[None, :]).reshape(-1),
            col,
        ] += sign * g7.reshape(-1)

    for b in range(N_ANGLE_BINS):
        for i in range(N_PAIRS):
            stamp(b * N_PAIRS + i, lut[b, i], -1.0)
            stamp(b * N_PAIRS + i, lut[b, N_PAIRS + i], +1.0)
    return D


def moment_weights(device) -> torch.Tensor:
    """[patch_px, 2] f32 (wx, wy) on ``device``."""
    wx, wy = _moment_weights()
    return torch.from_numpy(np.stack([wx, wy], axis=1)).to(device)


def pair_matrix(device, pair_matrix_np: np.ndarray | None = None, seed: int = 17) -> torch.Tensor:
    """The sampling matrix on ``device``, bf16-rounded as the JAX version
    feeds it to its matmul, held as f32."""
    D = pair_matrix_np if pair_matrix_np is not None else _pair_difference_matrix(seed)
    return torch.from_numpy(D).to(device).to(torch.bfloat16).float()


def orientations(patches: torch.Tensor, mweights: torch.Tensor) -> torch.Tensor:
    """Grey-centroid angle (radians, [-π, π]) per patch [N, P, P]
    (reference getGrayCentroid: θ = atan2(m01, m10), ORBExtractor.cc:465-487).
    ``mweights`` is ``moment_weights(device)``."""
    m = patches.reshape(patches.shape[0], -1).float() @ mweights  # [N, 2]
    return torch.atan2(m[:, 1], m[:, 0])


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool/int [..., 256] → int32 [..., 8], bit i of word w = bits[32w + i]
    (little-endian, as the JAX uint32 words).  Packs in int64, then wraps."""
    words = bits.reshape(*bits.shape[:-1], 8, 32).long()
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    return torch.sum(words << shifts, dim=-1).to(torch.int32)


def describe(patches: torch.Tensor, angles: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """BRIEF descriptors int32[N, 8] from raw patches [N, P, P] + angles.

    bit i = I_blur(rot(p1_i)) < I_blur(rot(p2_i)), the sign of
    patch · (g_{p2} − g_{p1}).  The patch is rounded to bf16 as in the JAX
    version and the product is taken in f32 (``D`` from ``pair_matrix``).
    """
    n = patches.shape[0]
    flat = patches.reshape(n, -1).to(torch.bfloat16).float()
    scores = (flat @ D).reshape(n, N_ANGLE_BINS, N_PAIRS)

    two_pi = 2.0 * np.pi
    frac = torch.remainder(angles, two_pi) / two_pi
    bins = torch.clamp((frac * N_ANGLE_BINS + 0.5).to(torch.int32) % N_ANGLE_BINS, 0, N_ANGLE_BINS - 1)
    sel = torch.gather(scores, 1, bins.long()[:, None, None].expand(n, 1, N_PAIRS))[:, 0]
    return pack_bits(sel > 0)


def angles_deg(angles_rad: torch.Tensor) -> torch.Tensor:
    """Angle in degrees [0, 360) — the rotation-consistency histogram's unit."""
    return torch.remainder(angles_rad * (180.0 / np.pi), 360.0)
