"""FAST-9/16 corner detection as whole-image batched tensor ops.

Port of ``orb_slam2_ros2_tpu/ops/fast.py``: the score map of every pixel at
once (16 rolled copies, a doubling min tree over 9-arcs), 3×3 non-max
suppression, and per-cell top-k selection in place of the reference's
quadtree (reference: src/ORBExtractor.cc:331-387, :19-192).

``fast_score_nms`` is the entry the extractor calls: on a CUDA tensor it
launches the hand-written kernel ``csrc/fast_nms.cu`` (the port of the TPU
kernel ``ops/pallas_fast.py``); on a CPU tensor it runs the plain version
``nms3(fast_score(x, th))`` beside it, with which the kernel is bit-exact on
every pixel.
"""

from __future__ import annotations

from typing import Tuple

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

# kernel launches made by fast_score_nms (one per call on a CUDA tensor)
fast_nms_launches = 0


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


def fast_score_nms(img: torch.Tensor, threshold: float, nms: bool = True) -> torch.Tensor:
    """FAST score map of bf16 ``img [B, H, W]``, 3×3-suppressed when ``nms``.

    CUDA tensors go through the ``fast_nms`` kernel (one launch); CPU tensors
    through the plain version.  Anything else raises.
    """
    if img.device.type == "cpu":
        score = fast_score(img, threshold)
        return nms3(score) if nms else score
    if img.device.type != "cuda":
        raise ValueError(f"fast_score_nms: unsupported device {img.device}")
    if img.dtype != torch.bfloat16 or img.dim() != 3 or not img.is_contiguous():
        raise ValueError(
            f"fast_score_nms kernel takes a contiguous bf16 [B, H, W] tensor, "
            f"got {img.dtype} {tuple(img.shape)} contiguous={img.is_contiguous()}"
        )
    B, H, W = img.shape
    out = torch.empty_like(img)
    if img.numel() == 0:
        return out
    lib = _build.load("fast_nms")
    with torch.cuda.device(img.device):
        rc = lib.fast_nms_bf16(
            img.data_ptr(), out.data_ptr(), B, H, W, float(threshold), int(bool(nms)),
            torch.cuda.current_stream(img.device).cuda_stream,
        )
    _build.check_launch(rc, "fast_nms")
    global fast_nms_launches
    fast_nms_launches += 1
    return out


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
