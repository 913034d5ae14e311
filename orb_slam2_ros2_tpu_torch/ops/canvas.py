"""Flat pyramid canvas layout (port of ``orb_slam2_ros2_tpu/ops/canvas.py``).

Every pyramid level is written into one tall ``[ΣHl, W0]`` canvas at a static
row offset, so a keypoint's patch address is ``(v_level + row_offset[octave],
u_level)`` — one gather space for all octaves.
"""

from __future__ import annotations

import numpy as np

from .pyramid import level_shapes


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
