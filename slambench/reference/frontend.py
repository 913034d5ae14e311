"""The plain reference of the ORB frontend the port runs inside its frame
graph: pyramid → FAST-9/16 + 3×3 NMS → per-cell selection → 48×64 patch
gather → grey-centroid orientation → folded-blur BRIEF → stereo match with
SAD refinement, or depth read from the depth map, and the lens's
fixed-point undistortion.  Plain PyTorch in one file: a frozen copy of the
plain versions of the port's ops (``ops/pyramid.py``, ``ops/canvas.py``,
``ops/fast.py``'s ``fast_score``/``nms3``/``select_keypoints``,
``ops/patches.py``'s ``extract_patches_plain``, ``ops/brief.py``,
``ops/hamming.py``, ``ops/stereo.py``, ``geometry/camera.py``'s
undistortion and ``features/extractor.py``), without the hand-written
kernels K1 and K2, the canvas table or any CUDA graph.  It imports nothing
of the port.

``precision="bf16"`` rounds where the configuration's frontend rounds: the
image, the pyramid levels, the resize weights, the patches and the BRIEF
sampling matrix to bfloat16, each product taken in float32.
``precision="fp8"`` is the control: the same values rounded to float8
(e4m3) instead, the nearest precision below bfloat16."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

CIRCLE_OFFSETS = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
                  (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1))
PATCH_ROWS, PATCH_COLS, PC = 48, 64, 22
N_PAIRS, N_ANGLE_BINS, TEMPLATE_CLIP, ORIENT_RADIUS = 256, 32, 13, 15


def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` rounded to the frontend's storage precision, held as bf16."""
    if precision == "fp8":
        return x.float().to(torch.float8_e4m3fn).to(torch.bfloat16)
    return x.to(torch.bfloat16)


# ---------------------------------------------------------------- pyramid
def level_shapes(h: int, w: int, n_levels: int, sf: float):
    return [(int(round(h / sf ** l)), int(round(w / sf ** l))) for l in range(n_levels)]


@lru_cache(maxsize=None)
def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] box-average (INTER_AREA) resampling matrix."""
    s = n_in / n_out
    W = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        lo, hi = i * s, (i + 1) * s
        for j in range(int(np.floor(lo)), min(int(np.ceil(hi)), n_in)):
            W[i, j] = (min(j + 1.0, hi) - max(float(j), lo)) / s
    return W


def pyramid(img: torch.Tensor, n_levels: int, sf: float, precision: str):
    """[B, H, W] f32 → levels [B, Hl, Wl] bf16, each resized from level 0
    (one shared column resize, then a row resize a level)."""
    h, w = img.shape[-2:]
    shapes = level_shapes(h, w, n_levels, sf)
    dev = img.device

    def weights(a):
        return _round(torch.from_numpy(a).to(dev), precision).float()

    Ww = weights(np.concatenate([_area_weights(w, wl).T for _, wl in shapes[1:]], axis=1))
    x = _round(img, precision)
    cols = _round(torch.matmul(x.float(), Ww), precision)
    levels, c0 = [x], 0
    for hl, wl in shapes[1:]:
        Wh = weights(_area_weights(h, hl))
        levels.append(_round(torch.matmul(Wh, cols[..., c0:c0 + wl].float()), precision))
        c0 += wl
    return levels


def canvas_layout(h: int, w: int, n_levels: int, sf: float):
    """(row offset of each level, padded rows, padded columns) of one
    image's canvas."""
    shapes = level_shapes(h, w, n_levels, sf)
    offs = np.cumsum([0] + [hl for hl, _ in shapes])
    return offs[:-1].astype(np.int32), int(offs[-1]) + 40, ((w + 210) + 127) // 128 * 128


# ---------------------------------------------------------------- FAST
def fast_score(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """FAST-9/16 response of every pixel of bf16 [..., H, W]; the ring wraps
    at the edges; differences in bf16, the threshold compare in f32."""
    d = torch.stack([torch.roll(img, (-dy, -dx), dims=(-2, -1)) for dy, dx in CIRCLE_OFFSETS]) - img[None]

    def arc_min(v):
        m = torch.minimum(v, torch.roll(v, -1, 0))
        m = torch.minimum(m, torch.roll(m, -2, 0))
        m = torch.minimum(m, torch.roll(m, -4, 0))
        return torch.minimum(m, torch.roll(v, -8, 0))

    score = torch.maximum(arc_min(d).amax(0), arc_min(-d).amax(0))
    return torch.where(score.float() > float(threshold), score, 0.0)


def nms3(score: torch.Tensor) -> torch.Tensor:
    h, w = score.shape[-2:]
    s = score.float()
    p = F.pad(s, (1, 1, 1, 1), value=float("-inf"))
    pooled = s
    for dy in range(3):
        for dx in range(3):
            pooled = torch.maximum(pooled, p[..., dy:dy + h, dx:dx + w])
    return torch.where(s >= pooled, score, 0.0)


def select_keypoints(score, capacity: int, border: int, cell: int, topk: int, strong: float):
    """Per-cell top-k, then the global top ``capacity`` by (rank in cell,
    −score); ties keep the lower index."""
    *lead, h, w = score.shape
    dev = score.device
    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    inb = (rows >= border) & (rows < h - border) & (cols >= border) & (cols < w - border)
    score = torch.where(inb, score.float(), 0.0)
    hc, wc = -(-h // cell), -(-w // cell)
    sp = F.pad(score, (0, wc * cell - w, 0, hc * cell - h))
    cells = sp.reshape(*lead, hc, cell, wc, cell).transpose(-3, -2).reshape(*lead, hc * wc, cell * cell)
    vals, idx = torch.sort(cells, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :topk], idx[..., :topk]
    cell_ids = torch.arange(hc * wc, device=dev)[:, None]
    py = (cell_ids // wc) * cell + idx // cell
    px = (cell_ids % wc) * cell + idx % cell
    rank = torch.arange(topk, device=dev)[None, :] + torch.where(vals >= strong, 0, topk)
    fv, fr = vals.reshape(*lead, -1), rank.reshape(*lead, -1)
    fpy, fpx = py.reshape(*lead, -1), px.reshape(*lead, -1)
    key = torch.where(fv > 0.0, -fr.float() * 1e4 + fv, float("-inf"))
    take = min(capacity, key.shape[-1])
    top_keys, top_idx = torch.sort(key, dim=-1, descending=True, stable=True)
    top_keys, top_idx = top_keys[..., :take], top_idx[..., :take]
    valid = torch.isfinite(top_keys)
    uv = torch.stack([torch.gather(fpx, -1, top_idx).float(), torch.gather(fpy, -1, top_idx).float()], dim=-1)
    resp = torch.gather(fv, -1, top_idx)
    if take < capacity:
        pad = capacity - take
        uv, resp = F.pad(uv, (0, 0, 0, pad)), F.pad(resp, (0, pad))
        valid = torch.cat([valid, torch.zeros((*lead, pad), dtype=torch.bool, device=dev)], dim=-1)
    return uv, resp, valid


def level_capacities(max_kp: int, n_levels: int, sf: float):
    weights = np.array([(1.0 / sf) ** l for l in range(n_levels)])
    caps = [max(8, int(c // 8 * 8)) for c in max_kp * weights / weights.sum()]
    caps[0] += max_kp - sum(caps)
    return caps


# ---------------------------------------------------------------- patches, BRIEF
def extract_patches(canvas: torch.Tensor, centers_yx: torch.Tensor) -> torch.Tensor:
    """48×64 windows at (y, x) centres, origins clamped as the kernel's
    (its 56×256 window, then into the canvas)."""
    h, w = canvas.shape
    c = centers_yx.long()
    y = torch.clamp(torch.clamp(c[:, 0] - PC, 0, h - PATCH_ROWS - 8), 0, h - PATCH_ROWS)
    x = torch.clamp(torch.clamp(c[:, 1] - PC, 0, w - PATCH_COLS - 192), 0, w - PATCH_COLS)
    rows = y[:, None, None] + torch.arange(PATCH_ROWS, device=canvas.device)[None, :, None]
    cols = x[:, None, None] + torch.arange(PATCH_COLS, device=canvas.device)[None, None, :]
    return canvas[rows, cols].float()


@lru_cache(maxsize=None)
def _pair_matrix_np(seed: int = 17) -> np.ndarray:
    """[48·64, 32·256] oriented-BRIEF sampling matrix with the 7×7 σ=2
    pre-compare blur folded in (+G7 at each pair's second point, −G7 at its
    first), for the seeded template rotated to each of 32 angle bins."""
    r = np.random.default_rng(seed)
    tpl = np.clip(np.round(r.normal(scale=TEMPLATE_CLIP / 2.0, size=(N_PAIRS, 4))),
                  -TEMPLATE_CLIP, TEMPLATE_CLIP).astype(np.int32).astype(np.float64)
    lut = np.zeros((N_ANGLE_BINS, 2 * N_PAIRS), np.int32)
    for b in range(N_ANGLE_BINS):
        th = 2.0 * np.pi * b / N_ANGLE_BINS
        c, s = np.cos(th), np.sin(th)
        for half, sl in ((tpl[:, 0:2], slice(0, N_PAIRS)), (tpl[:, 2:4], slice(N_PAIRS, 2 * N_PAIRS))):
            xr = np.round(c * half[:, 0] - s * half[:, 1]).astype(np.int32)
            yr = np.round(s * half[:, 0] + c * half[:, 1]).astype(np.int32)
            lut[b, sl] = (yr + PC) * PATCH_COLS + (xr + PC)
    x = np.arange(7) - 3.0
    k1 = np.exp(-0.5 * (x / 2.0) ** 2)
    k1 = (k1 / k1.sum()).astype(np.float32).astype(np.float64)
    g7 = np.outer(k1, k1).reshape(-1)
    D = np.zeros((PATCH_ROWS * PATCH_COLS, N_ANGLE_BINS * N_PAIRS), np.float32)
    for b in range(N_ANGLE_BINS):
        for i in range(N_PAIRS):
            for flat, sign in ((lut[b, i], -1.0), (lut[b, N_PAIRS + i], 1.0)):
                y, xx = divmod(int(flat), PATCH_COLS)
                idx = (np.arange(y - 3, y + 4)[:, None] * PATCH_COLS + np.arange(xx - 3, xx + 4)[None, :])
                D[idx.reshape(-1), b * N_PAIRS + i] += sign * g7
    return D


def _moment_weights(device) -> torch.Tensor:
    ys, xs = np.mgrid[0:PATCH_ROWS, 0:PATCH_COLS]
    ys, xs = ys - PC, xs - PC
    mask = (xs * xs + ys * ys) <= ORIENT_RADIUS * ORIENT_RADIUS
    return torch.from_numpy(np.stack([(xs * mask).astype(np.float32).reshape(-1),
                                      (ys * mask).astype(np.float32).reshape(-1)], axis=1)).to(device)


def describe(patches: torch.Tensor, precision: str):
    """(angle in degrees [0, 360), int32 [N, 8] descriptors) of raw patches."""
    n = patches.shape[0]
    m = patches.reshape(n, -1).float() @ _moment_weights(patches.device)
    ang = torch.atan2(m[:, 1], m[:, 0])
    D = _round(torch.from_numpy(_pair_matrix_np()).to(patches.device), precision).float()
    scores = (_round(patches.reshape(n, -1), precision).float() @ D).reshape(n, N_ANGLE_BINS, N_PAIRS)
    frac = torch.remainder(ang, 2.0 * np.pi) / (2.0 * np.pi)
    bins = torch.clamp((frac * N_ANGLE_BINS + 0.5).to(torch.int32) % N_ANGLE_BINS, 0, N_ANGLE_BINS - 1)
    sel = torch.gather(scores, 1, bins.long()[:, None, None].expand(n, 1, N_PAIRS))[:, 0]
    words = (sel > 0).reshape(n, 8, 32).long()
    desc = torch.sum(words << torch.arange(32, device=patches.device, dtype=torch.int64), dim=-1).to(torch.int32)
    return torch.remainder(ang * (180.0 / np.pi), 360.0), desc


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """int32 [..., 8] → int64 [..., 256] bits (bit i of word w at 32w + i)."""
    bits = (desc[..., :, None].long() >> torch.arange(32, device=desc.device)) & 1
    return bits.reshape(*desc.shape[:-1], 256)


def hamming_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    sa, sb = 1.0 - 2.0 * unpack_bits(a).float(), 1.0 - 2.0 * unpack_bits(b).float()
    return ((256 - sa @ sb.T) * 0.5).to(torch.int32)


# ---------------------------------------------------------------- lens, stereo, depth
def undistort(cam: dict, uv: torch.Tensor, iters: int = 8) -> torch.Tensor:
    f = {k: torch.tensor(float(cam.get(k, 0.0)), dtype=torch.float32, device=uv.device)
         for k in ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3")}
    xy0 = torch.stack([(uv[..., 0] - f["cx"]) / f["fx"], (uv[..., 1] - f["cy"]) / f["fy"]], dim=-1)
    xy = xy0
    for _ in range(iters):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (f["k1"] + r2 * (f["k2"] + r2 * f["k3"]))
        xd = x * radial + 2.0 * f["p1"] * x * y + f["p2"] * (r2 + 2.0 * x * x)
        yd = y * radial + f["p1"] * (r2 + 2.0 * y * y) + 2.0 * f["p2"] * x * y
        xy = xy0 - (torch.stack([xd, yd], dim=-1) - xy)
    return torch.stack([xy[..., 0] * f["fx"] + f["cx"], xy[..., 1] * f["fy"] + f["cy"]], dim=-1)


def stereo_match(L: dict, R: dict, pL, pR, *, sf, fx, bf, width, mean_th, sad_half, search_half):
    """(right_u, depth) [N] of the left keypoints; −1 where unmatched."""
    n, dev = L["uv"].shape[0], L["uv"].device
    dist = hamming_matrix(L["desc"], R["desc"])
    dv = (L["uv"][:, None, 1] - R["uv"][None, :, 1]).abs()
    du = L["uv"][:, None, 0] - R["uv"][None, :, 0]
    cand = (L["valid"][:, None] & R["valid"][None, :] & (dv <= 2.0 * torch.pow(sf, R["octave"].float())[None, :])
            & (du > 0.0) & (du < fx))
    BIG = 1 << 20
    masked = torch.where(cand, dist, BIG)
    best_j = torch.argmin(masked, dim=1)
    best_d = torch.gather(masked, 1, best_j[:, None])[:, 0]
    mutual = torch.argmin(masked, dim=0)[best_j] == torch.arange(n, device=dev)
    oct_r = R["octave"][best_j]
    ok = (best_d <= mean_th) & ((L["octave"] - oct_r).abs() <= 1) & (best_d < BIG) & mutual
    uvR = R["uv_raw"][best_j]
    w = sad_half
    patchL = pL[:, PC - w:PC + w + 1, PC - w:PC + w + 1]
    strip = pR[:, PC - w:PC + w + 1, PC - w - search_half:PC + w + search_half + 1][best_j]
    patchL = patchL - patchL[:, w, w][:, None, None]
    ns = 2 * search_half + 1
    wins = torch.stack([strip[:, :, s:s + 2 * w + 1] for s in range(ns)], dim=1)
    wins = wins - wins[:, :, w, w][:, :, None, None]
    scores = torch.sum((wins - patchL[:, None]).abs(), dim=(-1, -2))
    best_l = torch.argmin(scores, dim=1)
    interior = (best_l > 0) & (best_l < ns - 1)
    il = torch.clamp(best_l, 1, ns - 2)
    s1, s2, s3 = (torch.gather(scores, 1, il[:, None] + k)[:, 0] for k in (-1, 0, 1))
    denom = s1 + s3 - 2.0 * s2
    big = denom.abs() > 1e-6
    delta = torch.where(big, 0.5 * (s1 - s3) / torch.where(big, denom, 1.0), 0.0)
    delta = torch.where(interior & (delta.abs() < 1.0), delta, 0.0)
    shift = torch.where(interior, best_l.float() - search_half + delta, 0.0)
    right_u = torch.clamp(uvR[:, 0] + shift * torch.pow(sf, oct_r.float()), 0.0, float(width - 1))
    right_u = torch.where(L["uv"][:, 0] - right_u <= 0.0, uvR[:, 0], right_u)
    disp = L["uv"][:, 0] - right_u
    ok = ok & (disp > 0.5)
    depth = torch.where(ok, bf / torch.where(disp > 0, disp, 1.0), -1.0)
    return torch.where(ok, right_u, -1.0), depth


def frontend(img_a: torch.Tensor, img_b: torch.Tensor, cfg: dict, rgbd: bool, precision: str = "bf16") -> dict:
    """One frame's features as the port's frontend defines them: ``img_a``
    the left (or only) grey image, ``img_b`` the right image or the raw depth
    map, f32 [H, W] on one device; ``cfg`` a configuration's ``slam``
    section.  Returns uv, uv_raw, octave, desc, valid, right_u, depth and the
    canvas's shape and patch centres (for the patch gather's byte count)."""
    cam, orb, mt = cfg["camera"], cfg["orb"], cfg["matcher"]
    n_levels, sf = int(orb["n_levels"]), float(orb["scale_factor"])
    h, w = int(cam["height"]), int(cam["width"])
    imgs = (img_a[None] if rgbd else torch.stack([img_a, img_b])).float()
    B, dev = imgs.shape[0], imgs.device
    levels = pyramid(imgs, n_levels, sf, precision)
    row_off, rows_p, cols_p = canvas_layout(h, w, n_levels, sf)
    canvas = torch.zeros((B * rows_p, cols_p), dtype=torch.bfloat16, device=dev)
    for b in range(B):
        for off, lv in zip(row_off.tolist(), levels):
            canvas[b * rows_p + off:b * rows_p + off + lv.shape[-2], :lv.shape[-1]] = lv[b]
    caps = level_capacities(int(orb["max_keypoints"]), n_levels, sf)
    uts, valids, octs = [], [], []
    for l, lv in enumerate(levels):
        hl, wl = lv.shape[-2:]
        img_l = canvas.reshape(B, rows_p, cols_p)[:, row_off[l]:row_off[l] + hl, :wl]
        score = nms3(fast_score(img_l, float(orb["min_th_fast"])))
        uv_l, _, valid_l = select_keypoints(score, caps[l], int(orb["edge_border"]), int(orb["cell_size"]), 4,
                                            float(orb["ini_th_fast"]))
        uts.append(uv_l * (sf ** l))
        valids.append(valid_l)
        octs.append(torch.full((B, caps[l]), l, dtype=torch.int32, device=dev))
    uv_raw, valid, octave = torch.cat(uts, 1), torch.cat(valids, 1), torch.cat(octs, 1)
    N = uv_raw.shape[1]
    lc = uv_raw * torch.pow(1.0 / sf, octave.float())[..., None]
    roff = torch.from_numpy(row_off).to(dev)
    cy = torch.round(lc[..., 1]).to(torch.int32) + roff[octave.long()] + (torch.arange(B, device=dev) * rows_p)[:, None].int()
    cx = torch.round(lc[..., 0]).to(torch.int32)
    centers = torch.stack([cy, cx], dim=-1).reshape(B * N, 2)
    patches = extract_patches(canvas, centers)
    angle, desc = describe(patches, precision)
    patches, angle, desc = patches.reshape(B, N, PATCH_ROWS, PATCH_COLS), angle.reshape(B, N), desc.reshape(B, N, 8)
    distorted = any(float(cam.get(k, 0.0)) != 0.0 for k in ("k1", "k2", "p1", "p2", "k3"))
    uv = undistort(cam, uv_raw) if distorted else uv_raw
    feats = [dict(uv=uv[b], uv_raw=uv_raw[b], octave=octave[b], desc=desc[b], valid=valid[b], angle=angle[b])
             for b in range(B)]
    L = feats[0]
    bf = float(cam["fx"]) * float(cam["baseline"])
    if rgbd:
        yi = torch.round(L["uv_raw"][:, 1]).long().clamp(0, h - 1)
        xi = torch.round(L["uv_raw"][:, 0]).long().clamp(0, w - 1)
        d = img_b[yi, xi].float() / float(cam["depth_scale"])
        ok = L["valid"] & (d > 0.0)
        depth = torch.where(ok, d, -1.0)
        bf_t = torch.tensor(bf, dtype=torch.float32, device=dev)
        right_u = torch.where(ok, L["uv"][:, 0] - bf_t / torch.where(ok, d, 1.0), -1.0)
    else:
        right_u, depth = stereo_match(
            L, feats[1], patches[0], patches[1], sf=sf, fx=float(cam["fx"]), bf=bf, width=w,
            mean_th=int(mt["mean_threshold"]), sad_half=int(mt["sad_half_window"]),
            search_half=int(mt["sad_search_half"]))
    return dict(L, right_u=right_u, depth=depth, canvas_shape=tuple(canvas.shape), centers=centers,
                level_shapes=[tuple(lv.shape[-2:]) for lv in levels], batch=B)
