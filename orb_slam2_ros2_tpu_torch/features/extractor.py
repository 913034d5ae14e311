"""The ORB feature frontend: pyramid → FAST → orientation → BRIEF → stereo
or depth.

Port of ``orb_slam2_ros2_tpu/features/extractor.py`` (reference:
src/ORBExtractor.cc:499-508, src/Frame.cc:85-159).  Both images of a stereo
pair run through the same batched ops: [B, H, W] pyramids written into one
row-stacked canvas, one FAST+NMS kernel launch over every level of that
canvas, one patch-gather kernel launch over it, and the stereo matcher
reuses the gathered patches for SAD refinement.  The RGB-D frontend and the
one-image extractor (``make_extractor``) run the same ops on a one-image
canvas; the RGB-D frontend reads each keypoint's depth from the depth map.
Constant operators (resize
weights, moment weights, the BRIEF sampling matrix on the CPU or K3's tables
of it on CUDA) and the FAST kernel's level table are built once, when the
frontend is built, so a frame copies nothing from the host.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..config import SLAMConfig
from ..geometry import camera as cam_mod
from ..ops import brief, fast, stereo
from ..ops.canvas import build_canvas, canvas_layout, padded_canvas_shape
from ..ops.patches import extract_patches_48x64
from ..ops.pyramid import PyramidWeights, build_pyramid, pyramid_weights
from .frame import FrameFeatures, StereoFrame


def level_capacities(max_kp: int, n_levels: int, scale_factor: float) -> List[int]:
    """Distribute the padded keypoint budget over levels ∝ (1/s)^l
    (reference ORBExtractor.cc:291-301), rounded to multiples of 8 summing
    exactly."""
    inv = 1.0 / scale_factor
    weights = np.array([inv**l for l in range(n_levels)])
    raw = max_kp * weights / weights.sum()
    caps = [max(8, int(c // 8 * 8)) for c in raw]
    caps[0] += max_kp - sum(caps)
    return caps


class FrontendConstants(NamedTuple):
    """Device-resident operators of one frontend."""

    pyramid: PyramidWeights
    row_off: torch.Tensor    # i32[n_levels] canvas row offset per level
    fast_table: fast.PyramidTable  # where the FAST kernel finds each (image, level)
    mweights: torch.Tensor   # f32[patch_px, 2] grey-centroid weights
    brief: torch.Tensor | brief.K3Tables  # brief.operator: f32[patch_px, 8192] D on the CPU, K3's tables on CUDA


def frontend_constants(cfg: SLAMConfig, device, n_images: int = 2) -> FrontendConstants:
    """The operators of a frontend over ``n_images`` images a frame: 2 for
    a stereo pair, 1 for RGB-D (the FAST level table places that many
    pyramids in the canvas)."""
    o, c = cfg.orb, cfg.camera
    row_off, _, shapes = canvas_layout(c.height, c.width, o.n_levels, o.scale_factor)
    rows_p, cols_p = padded_canvas_shape(c.height, c.width, o.n_levels, o.scale_factor)
    return FrontendConstants(
        pyramid=pyramid_weights(c.height, c.width, o.n_levels, o.scale_factor, device),
        row_off=torch.from_numpy(row_off).to(device),
        fast_table=fast.pyramid_table(tuple(row_off.tolist()), tuple(shapes), n_images, rows_p, cols_p),
        mweights=brief.moment_weights(device),
        brief=brief.operator(device, _template(cfg)),
    )


def extract_features_batch(
    imgs: torch.Tensor,
    cam: cam_mod.CameraParams,
    consts: FrontendConstants,
    *,
    h: int,
    w: int,
    n_levels: int,
    scale_factor: float,
    caps: Tuple[int, ...],
    border: int,
    min_th: float,
    ini_th: float,
    cell: int,
    undistort: bool,
) -> Tuple[FrameFeatures, torch.Tensor]:
    """[B, H, W] images → (FrameFeatures with [B, N] leading dims,
    patches f32[B, N, 48, 64])."""
    B = imgs.shape[0]
    if B != consts.fast_table.batch:
        raise ValueError(f"the frontend's constants are for {consts.fast_table.batch} images, got {B}")
    dev = imgs.device
    levels = build_pyramid(imgs, n_levels, scale_factor, consts.pyramid)
    rows_p, cols_p = padded_canvas_shape(h, w, n_levels, scale_factor)

    # one tall canvas holding every image's pyramid (image b at row b·rows_p)
    canvas = torch.cat([build_canvas([lv[b] for lv in levels], cols_p, rows_p) for b in range(B)])

    scores = fast.fast_score_nms_pyramid(canvas, consts.fast_table, min_th)  # [B, Hl, Wl] each
    uts, resps, valids, octs = [], [], [], []
    for l, score in enumerate(scores):
        uv_l, resp_l, valid_l = fast.select_keypoints(
            score, caps[l], border=border, cell=cell, topk_per_cell=4,
            strong_threshold=ini_th,
        )
        uts.append(uv_l * (scale_factor**l))  # to level-0 coords
        resps.append(resp_l)
        valids.append(valid_l)
        octs.append(torch.full((B, caps[l]), l, dtype=torch.int32, device=dev))

    uv_raw = torch.cat(uts, dim=1)        # [B, N, 2]
    response = torch.cat(resps, dim=1)
    valid = torch.cat(valids, dim=1)
    octave = torch.cat(octs, dim=1)
    N = uv_raw.shape[1]

    # one 48×64 patch gather serves orientation, BRIEF and the SAD refinement
    centers = stereo.canvas_centers(uv_raw, octave, scale_factor, consts.row_off)
    img_off = torch.arange(B, dtype=torch.int32, device=dev)[:, None] * rows_p
    centers = torch.stack([centers[..., 0] + img_off, centers[..., 1]], dim=-1)
    patches = extract_patches_48x64(canvas, centers.reshape(B * N, 2).contiguous())
    angles_rad = brief.orientations(patches, consts.mweights)
    desc = brief.describe(patches, angles_rad, consts.brief).reshape(B, N, 8)
    patches = patches.reshape(B, N, *patches.shape[1:])
    angles_rad = angles_rad.reshape(B, N)

    uv = (cam_mod.undistort_points(cam, uv_raw.reshape(B * N, 2)).reshape(B, N, 2)
          if undistort else uv_raw)
    feats = FrameFeatures(
        uv=uv, uv_raw=uv_raw, octave=octave, response=response,
        angle=brief.angles_deg(angles_rad), desc=desc, valid=valid,
    )
    return feats, patches


def _slice_frame(feats: FrameFeatures, b: int) -> FrameFeatures:
    return FrameFeatures(*(a[b] for a in feats))


def extract_features(
    img: torch.Tensor,
    cam: cam_mod.CameraParams,
    consts: FrontendConstants,
    **kw,
) -> Tuple[FrameFeatures, torch.Tensor]:
    """One image ``[H, W]`` → (FrameFeatures, patches f32[N, 48, 64]); the
    constants are a one-image frontend's."""
    feats, patches = extract_features_batch(img[None], cam, consts, **kw)
    return _slice_frame(feats, 0), patches[0]


def _extract_kw(cfg: SLAMConfig) -> dict:
    """The static arguments of ``extract_features_batch`` for ``cfg``."""
    o, c = cfg.orb, cfg.camera
    return dict(
        h=c.height, w=c.width, n_levels=o.n_levels, scale_factor=o.scale_factor,
        caps=tuple(level_capacities(o.max_keypoints, o.n_levels, o.scale_factor)),
        border=o.edge_border, min_th=float(o.min_th_fast), ini_th=float(o.ini_th_fast),
        cell=o.cell_size, undistort=c.has_distortion,
    )


def _template(cfg: SLAMConfig):
    """The configured reference BRIEF template (None = the generated default)."""
    if cfg.orb.brief_template_path:
        return brief.load_template_file(cfg.orb.brief_template_path)
    return None


def _template_pair_matrix(cfg: SLAMConfig):
    """Per-instance BRIEF sampling matrix for a configured reference template
    (None = the generated default)."""
    tpl = _template(cfg)
    return None if tpl is None else brief.pair_matrix_for_template(tpl)


def _device_gray(img: torch.Tensor, color: int, luma: torch.Tensor) -> torch.Tensor:
    """Colour conversion on the device (reference Tracking.cc:52-68): ITU-R
    601 luma weights ``luma`` (channel-reversed for BGR).  Grayscale inputs
    pass through."""
    if color == 0 or img.dim() == 2:
        return img
    if color == 2:
        luma = luma.flip(0)
    return img[..., :3].float() @ luma


class StereoFrontend:
    """Stereo frontend: ``(img_l, img_r, cam) → StereoFrame`` on one device."""

    n_images = 2

    def __init__(self, cfg: SLAMConfig, device):
        self.cfg = cfg
        self.consts = frontend_constants(cfg, device, self.n_images)
        self.luma = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32, device=device)
        self.kw = _extract_kw(cfg)

    def __call__(self, img_l: torch.Tensor, img_r: torch.Tensor, cam: cam_mod.CameraParams) -> StereoFrame:
        c, o, m = self.cfg.camera, self.cfg.orb, self.cfg.matcher
        img_l = _device_gray(img_l, c.color, self.luma)
        img_r = _device_gray(img_r, c.color, self.luma)
        feats, patches = extract_features_batch(
            torch.stack([img_l, img_r]).float(), cam, self.consts, **self.kw
        )
        featL, featR = _slice_frame(feats, 0), _slice_frame(feats, 1)
        right_u, depth = stereo.stereo_match(
            featL, featR, patches[0], patches[1],
            fx=c.fx, bf=c.bf, image_width=c.width, scale_factor=o.scale_factor,
            mean_threshold=m.mean_threshold, sad_half=m.sad_half_window,
            search_half=m.sad_search_half,
        )
        return StereoFrame(feats=featL, right_u=right_u, depth=depth)


class RGBDFrontend(StereoFrontend):
    """RGB-D frontend: ``(img, depth_map, cam) → StereoFrame``.  Depth is
    sampled at each keypoint's rounded raw coordinates and becomes a
    synthetic right-image coordinate ``right_u = u − bf/d`` (reference RGB-D
    factory, Frame.cc:125-159)."""

    n_images = 1

    def __call__(self, img: torch.Tensor, depth_map: torch.Tensor, cam: cam_mod.CameraParams) -> StereoFrame:
        c = self.cfg.camera
        img = _device_gray(img, c.color, self.luma)
        feats, _ = extract_features(img.float(), cam, self.consts, **self.kw)
        yi = torch.round(feats.uv_raw[:, 1]).long().clamp(0, c.height - 1)
        xi = torch.round(feats.uv_raw[:, 0]).long().clamp(0, c.width - 1)
        d = depth_map[yi, xi].float() / c.depth_scale
        ok = feats.valid & (d > 0.0)
        depth = torch.where(ok, d, -1.0)
        right_u = torch.where(ok, feats.uv[:, 0] - cam.bf / torch.where(ok, d, 1.0), -1.0)
        return StereoFrame(feats=feats, right_u=right_u, depth=depth)


class Extractor:
    """One-image extractor: ``(img [H, W], cam) → (FrameFeatures, patches
    f32[N, 48, 64])``; one FAST launch and one patch launch a call on CUDA."""

    def __init__(self, cfg: SLAMConfig, device):
        self.consts = frontend_constants(cfg, device, n_images=1)
        self.kw = _extract_kw(cfg)

    def __call__(self, img: torch.Tensor, cam: cam_mod.CameraParams) -> Tuple[FrameFeatures, torch.Tensor]:
        return extract_features(img.float(), cam, self.consts, **self.kw)


def make_extractor(cfg: SLAMConfig, device="cuda") -> Extractor:
    return Extractor(cfg, device)


def make_stereo_frontend(cfg: SLAMConfig, device="cuda") -> StereoFrontend:
    return StereoFrontend(cfg, device)


def make_rgbd_frontend(cfg: SLAMConfig, device="cuda") -> RGBDFrontend:
    return RGBDFrontend(cfg, device)
