"""The card's published peaks and the work the two hand-written kernels'
jobs need, counted from the configuration's shapes (copies of the
arithmetic of ``chip_smoke.py``'s ``k1_bound_ms`` and ``k2_bound_ms``).
They count what the job needs, whatever implements it, so a later kernel is
judged against the same yardstick."""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAKS = {"hbm_bytes_per_s": 3.35e12, "f32_ops_per_s": 67e12}
# FAST-9/16 + 3×3 NMS a pixel: 16 ring subtractions, 2 × 47 min/max for the
# best 9-arc of each sign, 1 max of the signs, 1 threshold compare, 8 maxes
# and 1 compare of the suppression
K1_OPS_PER_PIXEL = 16 + 2 * 47 + 1 + 1 + 8 + 1
PATCH_ROWS, PATCH_COLS = 48, 64


def k1_work(level_shapes, batch: int) -> dict:
    """FAST + NMS over every pyramid level of ``batch`` images: each pixel
    read once and its score written once (bf16), K1_OPS_PER_PIXEL
    operations a pixel."""
    px = batch * sum(h * w for h, w in level_shapes)
    return {"ops": float(K1_OPS_PER_PIXEL * px), "bytes": 4.0 * px}


def k2_work(canvas_shape, centers_yx: np.ndarray) -> dict:
    """The 48×64 patch gather: the f32 patches written once and the canvas
    pixels their windows cover (bf16) read once; no arithmetic binds it."""
    h, w = canvas_shape
    c = np.asarray(centers_yx, np.int64)
    y = np.clip(np.clip(c[:, 0] - 22, 0, h - PATCH_ROWS - 8), 0, h - PATCH_ROWS)
    x = np.clip(np.clip(c[:, 1] - 22, 0, w - PATCH_COLS - 192), 0, w - PATCH_COLS)
    cover = np.zeros((h, w), bool)
    for yy, xx in zip(y, x):
        cover[yy:yy + PATCH_ROWS, xx:xx + PATCH_COLS] = True
    return {"ops": 0.0, "bytes": 2.0 * int(cover.sum()) + 4.0 * len(c) * PATCH_ROWS * PATCH_COLS}


def least_seconds(work: dict, peaks: dict = PEAKS) -> float:
    """The least time the card could take: operations at the f32 peak or
    bytes at the HBM peak, whichever is longer."""
    return max(work["ops"] / peaks["f32_ops_per_s"], work["bytes"] / peaks["hbm_bytes_per_s"])
