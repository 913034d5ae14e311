"""FAST-9/16 corner detection as whole-image batched tensor ops.

Port of ``orb_slam2_ros2_tpu/ops/fast.py``: the score map of every pixel at
once (16 rolled copies, a doubling min tree over 9-arcs), 3×3 non-max
suppression, and per-cell top-k selection in place of the reference's
quadtree (reference: src/ORBExtractor.cc:331-387, :19-192).

``fast_score_nms_pyramid`` is the entry the extractor calls, once a frame:
on a CUDA canvas it launches the hand-written kernel ``csrc/fast_nms.cu``
(the port of the TPU kernel ``ops/pallas_fast.py``) once over every level of
every image, as a ``PyramidTable`` places them in the row-stacked canvas; on
a CPU canvas it runs the plain version ``nms3(fast_score(level, th))`` level
by level, with which the kernel is bit-exact on every pixel.
``fast_score_nms`` scores one ``[B, H, W]`` level with the same kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

# Bresenham circle of radius 3, 16 points, clockwise from 12 o'clock — the
# standard FAST-16 ring (same ring cv::FAST uses).  (dy, dx) pairs.
CIRCLE_OFFSETS = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

ARC_LEN = 9  # FAST-9: 9 contiguous circle pixels (cv::FastFeatureDetector::TYPE_9_16)

# kernel launches made by fast_score_nms_pyramid and fast_score_nms (one per
# call on a CUDA tensor; a call inside a CUDA-graph capture records the
# kernel and launches nothing, so it counts nothing)
fast_nms_launches = 0

# the kernel's output tile and table capacity (csrc/fast_nms.cu OUT_W, OUT_H,
# MAX_SEGS)
TILE_W, TILE_H = 62, 30
MAX_SEGS = 32


class _LevelTable(ctypes.Structure):
    """The kernel's ``LevelTable`` (csrc/fast_nms.cu), passed by value."""

    _fields_ = [
        ("n_segs", ctypes.c_int), ("row_stride", ctypes.c_int),
        ("row_base", ctypes.c_int * MAX_SEGS), ("h", ctypes.c_int * MAX_SEGS),
        ("w", ctypes.c_int * MAX_SEGS), ("tiles_x", ctypes.c_int * MAX_SEGS),
        ("tile_start", ctypes.c_int * (MAX_SEGS + 1)), ("out_off", ctypes.c_int * MAX_SEGS),
    ]


class PyramidTable(NamedTuple):
    """Where each (image, level) map lies in a row-stacked bf16 canvas and
    where its scores go: the host-side table of one FAST launch.

    ``segs`` rows are level-major, (image, level) = (b, l) at row
    ``l * batch + b``: canvas row of the map's row 0 (column 0 is canvas
    column 0), height, width, tiles across, first tile of the flat grid,
    offset of its ``[Hl, Wl]`` scores in the flat output.
    """

    segs: np.ndarray           # i32 [S, 6]: row_base, Hl, Wl, tiles_x, tile_start, out_off
    n_tiles: int               # grid size
    canvas_shape: Tuple[int, int]
    batch: int
    level_shapes: Tuple[Tuple[int, int], ...]
    level_out: Tuple[int, ...]  # offset of each level's [batch, Hl, Wl] block in the output
    out_numel: int
    cstruct: _LevelTable


@functools.lru_cache(maxsize=None)
def pyramid_table(row_offsets: Tuple[int, ...], level_shapes: Tuple[Tuple[int, int], ...],
                  batch: int, image_rows: int, row_stride: int) -> PyramidTable:
    """Table of the maps of ``batch`` images stacked every ``image_rows``
    canvas rows, level ``l`` of each at row offset ``row_offsets[l]``."""
    n = len(level_shapes) * batch
    if n > MAX_SEGS:
        raise ValueError(f"fast_nms: {n} (image, level) maps, the kernel takes {MAX_SEGS}")
    segs, level_out = [], []
    tiles = out = 0
    for off, (hl, wl) in zip(row_offsets, level_shapes):
        if off + hl > image_rows or wl > row_stride:
            raise ValueError(f"fast_nms: level {hl}x{wl} at row {off} leaves the canvas image")
        level_out.append(out)
        tx = -(-wl // TILE_W)
        for b in range(batch):
            segs.append((b * image_rows + off, hl, wl, tx, tiles, out))
            tiles += tx * -(-hl // TILE_H)
            out += hl * wl
    if out >= 2**31:
        raise ValueError("fast_nms: output exceeds int32 offsets")
    segs = np.array(segs, np.int32).reshape(-1, 6)
    c = _LevelTable(n_segs=n, row_stride=row_stride)
    for j, field in enumerate(("row_base", "h", "w", "tiles_x", "tile_start", "out_off")):
        getattr(c, field)[:n] = segs[:, j].tolist()
    c.tile_start[n] = tiles
    return PyramidTable(segs, tiles, (batch * image_rows, row_stride), batch,
                        tuple(level_shapes), tuple(level_out), out, c)


def fast_score(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Exact FAST-9/16 corner response for every pixel of [..., H, W]
    (leading dims batch).  Ring pixels wrap around the image edges.

    Returns 0 where not a corner at ``threshold``, else the maximum over
    qualifying 9-arcs of the minimum absolute circle difference.  The
    differences are taken in the input dtype (bf16 on the main path); the
    threshold compare is in f32.
    """
    d = torch.stack(
        [torch.roll(img, (-int(dy), -int(dx)), dims=(-2, -1)) for dy, dx in CIRCLE_OFFSETS]
    ) - img[None]  # [16, ..., H, W]

    def arc_min(v: torch.Tensor) -> torch.Tensor:
        """min over 9 consecutive ring entries (circular), log-depth doubling."""
        m = v
        m = torch.minimum(m, torch.roll(m, -1, 0))  # 2
        m = torch.minimum(m, torch.roll(m, -2, 0))  # 4
        m = torch.minimum(m, torch.roll(m, -4, 0))  # 8
        m = torch.minimum(m, torch.roll(v, -8, 0))  # 9
        return m

    score = torch.maximum(arc_min(d).amax(0), arc_min(-d).amax(0))
    return torch.where(score.float() > float(threshold), score, 0.0)


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3×3 non-max suppression over the trailing two axes: keep pixels equal
    to their neighbourhood max; out-of-image neighbours are skipped (the
    -inf "SAME" padding of the JAX version)."""
    h, w = score.shape[-2:]
    s = score.float()
    p = F.pad(s, (1, 1, 1, 1), value=float("-inf"))
    pooled = s
    for dy in range(3):
        for dx in range(3):
            pooled = torch.maximum(pooled, p[..., dy:dy + h, dx:dx + w])
    return torch.where(s >= pooled, score, 0.0)


def fast_score_nms_pyramid(canvas: torch.Tensor, table: PyramidTable, threshold: float,
                           nms: bool = True, out: torch.Tensor | None = None) -> List[torch.Tensor]:
    """FAST score maps of every level of the bf16 canvas ``table`` describes,
    3×3-suppressed when ``nms``: one ``[batch, Hl, Wl]`` map per level, views
    of one flat buffer (``out`` when given: bf16 ``[table.out_numel]``).

    A CUDA canvas goes through one launch of the ``fast_nms`` kernel; a CPU
    canvas through the plain version, level by level.  Anything else raises.
    """
    shapes = table.level_shapes
    if tuple(canvas.shape) != table.canvas_shape:
        raise ValueError(f"fast_score_nms_pyramid: canvas {tuple(canvas.shape)}, the table "
                         f"places its maps in {table.canvas_shape}")
    if canvas.device.type == "cpu":
        imgs = canvas.reshape(table.batch, -1, canvas.shape[-1])
        maps = []
        for l, (hl, wl) in enumerate(shapes):
            r0 = int(table.segs[l * table.batch, 0])
            score = fast_score(imgs[:, r0:r0 + hl, :wl], threshold)
            maps.append(nms3(score) if nms else score)
        if out is None:
            return maps
        return [o.copy_(m) for o, m in zip(_level_views(out, table), maps)]
    if canvas.device.type != "cuda":
        raise ValueError(f"fast_score_nms_pyramid: unsupported device {canvas.device}")
    if canvas.dtype != torch.bfloat16 or not canvas.is_contiguous():
        raise ValueError(f"fast_nms kernel takes a contiguous bf16 canvas, got {canvas.dtype} "
                         f"contiguous={canvas.is_contiguous()}")
    if out is None:
        out = torch.empty(table.out_numel, dtype=torch.bfloat16, device=canvas.device)
    elif (out.dtype != torch.bfloat16 or out.shape != (table.out_numel,)
          or out.device != canvas.device or not out.is_contiguous()):
        raise ValueError(f"fast_score_nms_pyramid: out must be a contiguous bf16 "
                         f"[{table.out_numel}] tensor on {canvas.device}")
    lib = _build.load("fast_nms")
    with torch.cuda.device(canvas.device):
        rc = lib.fast_nms_pyramid_bf16(
            canvas.data_ptr(), out.data_ptr(), ctypes.addressof(table.cstruct),
            float(threshold), int(bool(nms)), torch.cuda.current_stream(canvas.device).cuda_stream,
        )
    _build.check_launch(rc, "fast_nms")
    if not torch.cuda.is_current_stream_capturing():
        global fast_nms_launches
        fast_nms_launches += 1
    return _level_views(out, table)


def _level_views(out: torch.Tensor, table: PyramidTable) -> List[torch.Tensor]:
    return [out[o:o + table.batch * hl * wl].view(table.batch, hl, wl)
            for o, (hl, wl) in zip(table.level_out, table.level_shapes)]


def fast_score_nms(img: torch.Tensor, threshold: float, nms: bool = True) -> torch.Tensor:
    """FAST score map of bf16 ``img [B, H, W]``, 3×3-suppressed when ``nms``:
    a one-level call of ``fast_score_nms_pyramid``."""
    if img.dim() != 3:
        raise ValueError(f"fast_score_nms takes [B, H, W], got {tuple(img.shape)}")
    B, H, W = img.shape
    table = pyramid_table((0,), ((H, W),), B, H, W)
    return fast_score_nms_pyramid(img.reshape(B * H, W), table, threshold, nms)[0]


def _dispatch(img: torch.Tensor, threshold: float, nms: bool) -> torch.Tensor:
    lead, (h, w) = img.shape[:-2], img.shape[-2:]
    out = fast_score_nms(img.reshape(-1, h, w).contiguous(), threshold, nms)
    return out.reshape(*lead, h, w)


def fast_score_dispatch(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """FAST score map of bf16 ``img [..., H, W]`` (leading dims batch): one
    K1 launch on a CUDA tensor, ``fast_score`` on a CPU tensor; bit-equal on
    every pixel."""
    return _dispatch(img, threshold, nms=False)


def fast_score_nms_dispatch(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """FAST score + 3×3 NMS of bf16 ``img [..., H, W]``: one K1 launch on a
    CUDA tensor, ``nms3(fast_score)`` on a CPU tensor; bit-equal on every
    pixel."""
    return _dispatch(img, threshold, nms=True)


def select_keypoints(
    score: torch.Tensor,
    capacity: int,
    border: int,
    cell: int = 16,
    topk_per_cell: int = 4,
    strong_threshold: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Spatially-uniform top-``capacity`` corner selection (quadtree
    replacement) over ``score [..., h, w]`` (leading dims batch).

    Returns (uv [..., capacity, 2] f32 in (u=x, v=y) order, response
    [..., capacity] f32, valid [..., capacity] bool).  Ranking key: (rank
    within cell, −score); corners at or above ``strong_threshold`` outrank
    weaker ones one rank-class earlier.  Ties keep the lower index first, as
    ``lax.top_k`` does.
    """
    *lead, h, w = score.shape
    dev = score.device
    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    in_border = (rows >= border) & (rows < h - border) & (cols >= border) & (cols < w - border)
    # f32 holds every bf16 value exactly, so the ranking is unchanged
    score = torch.where(in_border, score.float(), 0.0)

    hc, wc = -(-h // cell), -(-w // cell)
    sp = F.pad(score, (0, wc * cell - w, 0, hc * cell - h))
    cells = sp.reshape(*lead, hc, cell, wc, cell).transpose(-3, -2).reshape(*lead, hc * wc, cell * cell)

    k = topk_per_cell
    vals, idx = torch.sort(cells, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]                        # [..., hc*wc, k]
    cell_ids = torch.arange(hc * wc, device=dev)[:, None]
    py = (cell_ids // wc) * cell + idx // cell
    px = (cell_ids % wc) * cell + idx % cell
    rank = torch.arange(k, device=dev)[None, :] + torch.where(vals >= strong_threshold, 0, k)

    flat_vals = vals.reshape(*lead, -1)
    flat_rank = rank.reshape(*lead, -1)
    flat_py = py.reshape(*lead, -1)
    flat_px = px.reshape(*lead, -1)
    valid_cand = flat_vals > 0.0

    key = torch.where(valid_cand, -flat_rank.float() * 1e4 + flat_vals, float("-inf"))
    n_cand = key.shape[-1]
    take = min(capacity, n_cand)
    top_keys, top_idx = torch.sort(key, dim=-1, descending=True, stable=True)
    top_keys, top_idx = top_keys[..., :take], top_idx[..., :take]
    sel_valid = torch.isfinite(top_keys)
    uv = torch.stack(
        [torch.gather(flat_px, -1, top_idx).float(), torch.gather(flat_py, -1, top_idx).float()],
        dim=-1,
    )
    resp = torch.gather(flat_vals, -1, top_idx)
    if take < capacity:
        pad = capacity - take
        uv = F.pad(uv, (0, 0, 0, pad))
        resp = F.pad(resp, (0, pad))
        sel_valid = torch.cat(
            [sel_valid, torch.zeros((*lead, pad), dtype=torch.bool, device=dev)], dim=-1
        )
    return uv, resp, sel_valid
