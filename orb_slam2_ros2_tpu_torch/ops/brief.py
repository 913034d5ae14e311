"""Oriented-BRIEF description (port of ``orb_slam2_ros2_tpu/ops/brief.py``).

Grey-centroid orientation, then a 256-pair template rotated to one of 32
angle bins, with the 7×7 pre-compare Gaussian blur folded into one sampling
matrix (reference: src/ORBExtractor.cc:465-487, :427-456).  The numpy
builders of the template, the rotated-offset LUT and the pair-difference
matrix are copies of the JAX package's (tested equal).

Descriptors are int32 [N, 8]: the bits of the JAX package's uint32 words,
reinterpreted (torch has no shifts on uint32).

``describe`` on a CPU tensor is the plain version (``describe_plain``: the
patches times the dense [3072, 8192] matrix, all 32 bins scored, one kept).
On a CUDA tensor it launches the hand-written kernel ``csrc/brief.cu`` (K3),
which scores only the bin each keypoint uses, from each column's nonzero
taps (``k3_tables``), summed in ascending row order.  ``operator`` builds
what ``describe`` takes on a device: D on the CPU, K3's tables on CUDA.

``set_template_file`` makes a file-loaded template the process-wide default
of ``brief_template`` and of every table derived from it (tests and simple
scripts; a frontend binds ``orb.brief_template_path`` per instance instead,
and keeps the sampling matrix it was built with).
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from .patches import CENTER as PATCH_CENTER
from .patches import PATCH_COLS, PATCH_ROWS

N_PAIRS = 256
N_ANGLE_BINS = 32
PATCH_HALF = PATCH_CENTER  # keypoint border requirement (rows above/left)
TEMPLATE_CLIP = 13       # max |coordinate| of a template point pre-rotation
ORIENT_RADIUS = 15       # grey-centroid circular patch radius (ORBExtractor.cc:518)
BLUR_PAD = 3             # 7-tap Gaussian apron

_TEMPLATE_OVERRIDE = None  # set by set_template_file()

# K3 launches made by describe (one per call on a CUDA tensor; a call inside a
# CUDA-graph capture records the kernel and counts nothing)
brief_launches = 0


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


def angle_bins(angles: torch.Tensor) -> torch.Tensor:
    """int32 [N]: the template rotation (of N_ANGLE_BINS) each angle selects."""
    two_pi = 2.0 * np.pi
    frac = torch.remainder(angles, two_pi) / two_pi
    return torch.clamp((frac * N_ANGLE_BINS + 0.5).to(torch.int32) % N_ANGLE_BINS, 0, N_ANGLE_BINS - 1)


def describe_plain(patches: torch.Tensor, angles: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """BRIEF descriptors int32[N, 8] from raw patches [N, P, P] + angles.

    bit i = I_blur(rot(p1_i)) < I_blur(rot(p2_i)), the sign of
    patch · (g_{p2} − g_{p1}).  The patch is rounded to bf16 as in the JAX
    version and the product is taken in f32 (``D`` from ``pair_matrix``).
    """
    n = patches.shape[0]
    flat = patches.reshape(n, -1).to(torch.bfloat16).float()
    scores = (flat @ D).reshape(n, N_ANGLE_BINS, N_PAIRS)
    bins = angle_bins(angles)
    sel = torch.gather(scores, 1, bins.long()[:, None, None].expand(n, 1, N_PAIRS))[:, 0]
    return pack_bits(sel > 0)


# ---------------------------------------------------------------- K3's tables
#
# Column (bin b, pair i) of D is a −G7 stamp at the pair's first point and a
# +G7 stamp at its second, bf16-rounded, the two summed in f32 where they
# overlap: at most 98 nonzero rows.  K3 reads each column as its 14 row
# segments of 7 taps (7 rows of each stamp) in ascending row order, so it
# sums the column's taps in the order of the rows.  Where the two stamps
# share a row and overlap, the left segment's covered taps take the summed
# weight and the right segment's covered taps weight 0 (they were taken
# already): a weight-0 tap adds ±0 to a sum, which leaves every bit as it
# is.  One int32 a segment: bits 0-5 its patch row, 6-11 its first column,
# 12-21 its row of the weight table (the 7 bf16 weights of its taps; a few
# hundred distinct rows).

K3_SEGMENTS = 14
K3_TAPS = 7
K3_MAX_WEIGHT_ROWS = 1024


class K3Tables(NamedTuple):
    """What K3 reads of one template, on its device."""

    segs: torch.Tensor     # int32 [N_ANGLE_BINS, 14, N_PAIRS] segment words, see above
    weights: torch.Tensor  # int32 [rows, 4]: 8 bf16 weights a row (the 8th 0), two a word, low half first


def _k3_arrays(lut: np.ndarray):
    """(segment words, weight rows) of ``_pair_matrix_from_lut(lut)`` as
    ``pair_matrix`` rounds it; the weights are worked out as that function
    adds its stamps (f32 of −G7, then of the f64 sum with +G7), bf16-rounded."""
    from .pyramid import _gaussian_kernel_1d

    k1 = _gaussian_kernel_1d(7, 2.0).astype(np.float64)
    g = np.outer(k1, k1)                                       # [7, 7] float64, as _pair_matrix_from_lut's
    first = (-g).astype(np.float32)                            # a first point's stamp alone
    pts = lut.reshape(N_ANGLE_BINS, 2, N_PAIRS).astype(np.int64)
    y, x = pts // PATCH_COLS, pts % PATCH_COLS                 # [bins, 2, pairs]
    stamp = np.repeat(np.arange(2), K3_TAPS)                   # segment → stamp
    w, ro = stamp[None, :, None], np.tile(np.arange(K3_TAPS), 2)[None, :, None]
    yw, xw, yo, xo = y[:, stamp], x[:, stamp], y[:, 1 - stamp], x[:, 1 - stamp]  # [bins, 14, pairs]
    r, x0 = yw - 3 + ro, xw - 3
    if r.min() < 0 or r.max() >= PATCH_ROWS or x0.min() < 0 or x0.max() + K3_TAPS > PATCH_COLS:
        raise ValueError("a template stamp leaves the 48×64 patch")
    c = np.arange(K3_TAPS)                                     # tap → column in its stamp
    own = np.where(w[..., None] == 0, first[ro], g[ro].astype(np.float32))  # [1, 14, 1, 7]
    ro_o, c_o = (r - yo + 3)[..., None], (x0 - xo + 3)[..., None] + c       # the tap in the other stamp
    covered = (ro_o >= 0) & (ro_o < K3_TAPS) & (c_o >= 0) & (c_o < K3_TAPS)
    ro_o, c_o = np.clip(ro_o, 0, 6), np.clip(c_o, 0, 6)
    summed = np.where(w[..., None] == 0, own.astype(np.float64) + g[ro_o, c_o],
                      first[ro_o, c_o].astype(np.float64) + g[ro]).astype(np.float32)
    left = ((xw < xo) | ((xw == xo) & (w == 0)))[..., None]   # the row's first segment takes the sum
    wt = np.where(covered, np.where(left, summed, np.float32(0.0)), own)
    bits = torch.from_numpy(np.ascontiguousarray(wt)).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    rows = np.concatenate([bits, np.zeros((*bits.shape[:-1], 1), np.uint16)], -1).reshape(-1, 8)
    table, row_id = np.unique(rows.view(np.dtype((np.void, 16))).ravel(), return_inverse=True)
    if len(table) > K3_MAX_WEIGHT_ROWS:
        raise ValueError(f"{len(table)} weight rows, K3 stages at most {K3_MAX_WEIGHT_ROWS}")
    word = r | x0 << 6 | row_id.reshape(r.shape) << 12
    order = np.argsort((r * PATCH_COLS + x0) * 2 + w, axis=1, kind="stable")
    segs = np.take_along_axis(word, order, 1).astype(np.int32)
    return segs, table.view(np.int32).reshape(-1, 4)


_K3_CACHE: dict = {}


def k3_tables(device, tpl: np.ndarray | None = None, seed: int = 17) -> K3Tables:
    """K3's tables on ``device`` for an explicit template array, or for the
    default template (seeded, or the file-loaded override) — the template
    ``pair_matrix`` builds D from."""
    lut = _lut_from_template(tpl) if tpl is not None else rotated_offset_lut(seed)
    key = lut.tobytes()
    if key not in _K3_CACHE:
        _K3_CACHE[key] = _k3_arrays(lut)
    segs, weights = _K3_CACHE[key]
    return K3Tables(segs=torch.from_numpy(segs).to(device), weights=torch.from_numpy(weights).to(device))


def operator(device, tpl: np.ndarray | None = None):
    """What ``describe`` takes on ``device`` for an explicit template array,
    or for the default one: D (``pair_matrix``) on the CPU, K3's tables
    (``k3_tables``) on CUDA."""
    if torch.device(device).type == "cpu":
        return pair_matrix(device, None if tpl is None else pair_matrix_for_template(tpl))
    return k3_tables(device, tpl)


def describe(patches: torch.Tensor, angles: torch.Tensor, op) -> torch.Tensor:
    """BRIEF descriptors int32[N, 8] from raw f32 patches [N, 48, 64] +
    angles, with ``op`` from ``operator``: ``describe_plain`` on a CPU
    tensor, K3 on a CUDA tensor; anything else raises.  The two agree but
    where a score lies within f32 rounding of zero (their sums' order)."""
    if patches.device.type == "cpu":
        return describe_plain(patches, angles, op)
    if patches.device.type != "cuda":
        raise ValueError(f"describe: unsupported device {patches.device}")
    if tuple(angles.shape) != (patches.shape[0],) or angles.device != patches.device:
        raise ValueError(f"describe: {patches.shape[0]} patches need as many angles on {patches.device}, "
                         f"got {tuple(angles.shape)} on {angles.device}")
    return describe_kernel(patches, angle_bins(angles), op)


def describe_kernel(patches: torch.Tensor, bins: torch.Tensor, k3: K3Tables) -> torch.Tensor:
    """K3 on CUDA tensors: patches f32 [N, 48, 64], bins int32 [N]
    (``angle_bins``) → int32 [N, 8]."""
    n = patches.shape[0]
    if (patches.device.type != "cuda" or patches.dtype != torch.float32
            or tuple(patches.shape[1:]) != (PATCH_ROWS, PATCH_COLS) or not patches.is_contiguous()
            or patches.data_ptr() % 16):
        raise ValueError(f"brief kernel takes contiguous 16-byte aligned f32 [N, {PATCH_ROWS}, {PATCH_COLS}] "
                         f"CUDA patches, got {patches.dtype} {tuple(patches.shape)} on {patches.device}")
    if bins.dtype != torch.int32 or tuple(bins.shape) != (n,) or bins.device != patches.device \
            or not bins.is_contiguous():
        raise ValueError(f"brief kernel takes contiguous int32 [{n}] bins on {patches.device}")
    if not isinstance(k3, K3Tables) or any(t.device != patches.device or not t.is_contiguous()
                                           or t.dtype != torch.int32 for t in k3) \
            or tuple(k3.segs.shape) != (N_ANGLE_BINS, K3_SEGMENTS, N_PAIRS) \
            or k3.weights.dim() != 2 or k3.weights.shape[1] != 4 \
            or not 1 <= k3.weights.shape[0] <= K3_MAX_WEIGHT_ROWS:
        raise ValueError(f"brief kernel takes K3Tables on {patches.device} (k3_tables)")
    out = torch.empty((n, 8), dtype=torch.int32, device=patches.device)
    lib = _build.load("brief")
    with torch.cuda.device(patches.device):
        rc = lib.brief_describe(
            patches.data_ptr(), bins.data_ptr(), k3.segs.data_ptr(), k3.weights.data_ptr(),
            k3.weights.shape[0], out.data_ptr(), n, torch.cuda.current_stream(patches.device).cuda_stream,
        )
    _build.check_launch(rc, "brief")
    if not torch.cuda.is_current_stream_capturing():
        global brief_launches
        brief_launches += 1
    return out


def angles_deg(angles_rad: torch.Tensor) -> torch.Tensor:
    """Angle in degrees [0, 360) — the rotation-consistency histogram's unit."""
    return torch.remainder(angles_rad * (180.0 / np.pi), 360.0)
