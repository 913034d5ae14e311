"""Inputs and frontend pieces the tools share: rendered stereo frames, a
SLAM run to build a map, and the extractor's stages in its production order
(``features/extractor.py`` ``extract_features_batch``)."""

from __future__ import annotations

import dataclasses

import torch

from ..features.extractor import FrontendConstants, level_capacities
from ..io.synthetic import SyntheticStereoDataset
from ..ops import brief, fast, stereo
from ..ops.canvas import build_canvas, padded_canvas_shape
from ..ops.patches import extract_patches_48x64
from ..ops.pyramid import build_pyramid


def with_th_depth(cfg, th_depth: float = 60.0):
    """``cfg`` with the KITTI-like world's close-depth threshold (the JAX
    scripts' ``th_depth=60``)."""
    return cfg.replace(tracking=dataclasses.replace(cfg.tracking, th_depth=th_depth))


def render(cfg, n: int, device, lap: int = 0, **world) -> list:
    """The first ``n`` (left, right) pairs of a ``SyntheticStereoDataset``
    over ``lap`` frames (``n + 2`` when 0: a circle world's lap), at
    ``speed`` 0.8 unless given, on ``device``."""
    world.setdefault("speed", 0.8)
    ds = SyntheticStereoDataset(cfg.camera, n_frames=lap or n + 2, device=device, **world)
    return [ds.frame(i)[:2] for i in range(n)]


def run_slam(slam, frames) -> int:
    """Track every frame, flush; the number of frames with a pose."""
    tracked = sum(slam.track(il, ir)[0] is not None for il, ir in frames)
    slam.flush()
    return tracked


def clone(tree):
    """A copy of every tensor of a tree (``.to(device, copy=True)``: a plain
    ``.to`` on the same device returns the tensor itself)."""
    from ..pipeline.frame_graph import tree_map

    return tree_map(lambda t: t.to(t.device, copy=True), tree)


class Stages:
    """The extractor's work on a [B, H, W] batch, stage by stage, as
    ``extract_features_batch`` runs it; each method runs everything before
    it too."""

    def __init__(self, cfg, consts: FrontendConstants):
        o, c = cfg.orb, cfg.camera
        self.cfg, self.consts = cfg, consts
        self.caps = tuple(level_capacities(o.max_keypoints, o.n_levels, o.scale_factor))
        self.rows_p, self.cols_p = padded_canvas_shape(c.height, c.width, o.n_levels, o.scale_factor)

    def pyramid(self, imgs):
        o = self.cfg.orb
        return build_pyramid(imgs, o.n_levels, o.scale_factor, self.consts.pyramid)

    def canvas(self, imgs):
        levels = self.pyramid(imgs)
        return torch.cat([build_canvas([lv[b] for lv in levels], self.cols_p, self.rows_p)
                          for b in range(imgs.shape[0])])

    def fast(self, imgs):
        """Pyramid + canvas + K1 (one launch over the canvas)."""
        canvas = self.canvas(imgs)
        return canvas, fast.fast_score_nms_pyramid(canvas, self.consts.fast_table, float(self.cfg.orb.min_th_fast))

    def select(self, imgs):
        o = self.cfg.orb
        canvas, scores = self.fast(imgs)
        sel = [fast.select_keypoints(s, self.caps[l], border=o.edge_border, cell=o.cell_size, topk_per_cell=4,
                                     strong_threshold=float(o.ini_th_fast)) for l, s in enumerate(scores)]
        return canvas, sel

    def centers(self, imgs):
        o = self.cfg.orb
        B, dev = imgs.shape[0], imgs.device
        canvas, sel = self.select(imgs)
        uv_raw = torch.cat([uv * (o.scale_factor ** l) for l, (uv, _, _) in enumerate(sel)], dim=1)
        octave = torch.cat([torch.full((B, c), l, dtype=torch.int32, device=dev) for l, c in enumerate(self.caps)],
                           dim=1)
        centers = stereo.canvas_centers(uv_raw, octave, o.scale_factor, self.consts.row_off)
        img_off = torch.arange(B, dtype=torch.int32, device=dev)[:, None] * self.rows_p
        centers = torch.stack([centers[..., 0] + img_off, centers[..., 1]], dim=-1)
        return canvas, centers.reshape(-1, 2).contiguous()

    def patches(self, imgs):
        """... + K2 (one launch)."""
        canvas, centers = self.centers(imgs)
        return extract_patches_48x64(canvas, centers)

    def orientations(self, imgs):
        p = self.patches(imgs)
        return p, brief.orientations(p, self.consts.mweights)

    def describe(self, imgs):
        p, a = self.orientations(imgs)
        return brief.describe(p, a, self.consts.brief)
