"""Flat pyramid canvas layout (port of ``orb_slam2_ros2_tpu/ops/canvas.py``).

Every pyramid level is written into one tall ``[ΣHl, W0]`` canvas at a static
row offset, so a keypoint's patch address is ``(v_level + row_offset[octave],
u_level)`` — one gather space for all octaves.  ``build_canvas`` writes one
image's levels; ``extract_patches`` is the generic square gather (the
extractor's 48×64 patches are K2, ``ops/patches.py``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .pyramid import level_shapes
from .stereo import extract_rect


def canvas_layout(h: int, w: int, n_levels: int, scale_factor: float):
    """Static layout: (row_offsets [n_levels], total_rows, level_shapes)."""
    shapes = level_shapes(h, w, n_levels, scale_factor)
    offsets = []
    acc = 0
    for hl, _ in shapes:
        offsets.append(acc)
        acc += hl
    return np.array(offsets, np.int32), acc, shapes


def padded_canvas_shape(h: int, w: int, n_levels: int, scale_factor: float):
    """Canvas dims padded so the patch window's [56, 256] clamp bound never
    moves a legal keypoint's patch: cols ≥ w + 210 (rounded to 128), rows =
    total + 40."""
    _, total_rows, _ = canvas_layout(h, w, n_levels, scale_factor)
    cols = ((w + 210) + 127) // 128 * 128
    rows = total_rows + 40
    return rows, cols


def build_canvas(levels: Sequence[torch.Tensor], width: int, total_rows: int) -> torch.Tensor:
    """Stack per-level images ``[Hl, Wl]`` into a zero ``[total_rows, width]``
    canvas, level after level from row 0, each at column 0."""
    canvas = torch.zeros((total_rows, width), dtype=levels[0].dtype, device=levels[0].device)
    off = 0
    for lv in levels:
        hl, wl = lv.shape
        canvas[off:off + hl, :wl] = lv
        off += hl
    return canvas


def extract_patches(canvas: torch.Tensor, centers_yx: torch.Tensor, half: int) -> torch.Tensor:
    """``(2·half+1)²`` patches around integer centres ``[N, 2]`` (y, x),
    with ``lax.dynamic_slice``'s index rules (``stereo.extract_rect``)."""
    return extract_rect(canvas, centers_yx, half, half)
