#!/usr/bin/env python3
"""Drive the PyTorch port's SLAM paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (one line each; any failure raises and exits non-zero):
  1. the card (nvidia-smi name and power limit); no CUDA device → exit 1;
  2. build every CUDA kernel from ``orb_slam2_ros2_tpu_torch/csrc`` (nvcc);
  3. K1 ``fast_nms`` against its plain PyTorch version at the 8 KITTI pyramid
     level shapes, batch 2, NMS on and off — bit-equal (``torch.equal``):
     one launch over the stereo canvas holding both pyramids (as the
     extractor calls it) and one launch per level;
  4. K2 ``patches`` against its plain version on the KITTI stereo canvas with
     4096 centres, corners and clamp edges included — bit-equal;
  5. localization: ``SLAM`` in localization mode at the full KITTI width of
     the default ``SLAMConfig`` on 10 synthetic stereo frames rendered on
     the card.  Every frame must track OK within 0.05 m of ground truth, the
     median inlier count over frames 1-9 must reach 300, each kernel must
     launch exactly once on every frame, and frames 2-9 run the frame
     program under ``torch.cuda.set_sync_debug_mode("error")``;
  6. mapping: ``SLAM(enable_loop_closing=False)`` in the default mode (full
     SLAM, deferred mapping tail) at the default ``SLAMConfig`` with
     ``th_depth=60`` on 40 frames of the KITTI-like world (``box_scale=2.5``,
     sky, 0.8 m/frame).  Every frame must track OK, ≥ 4 keyframes must be
     inserted after keyframe 0, ≥ 1 local BA must run, after ``flush()`` the
     live ATE must stay under 5% and the final-trajectory ATE under 3% of
     the path length, each kernel must launch exactly once on every frame,
     and frames ≥ 2 — keyframe programs included — run under
     ``set_sync_debug_mode("error")``;
  7. relocalization in a saved map: the mapping run's map is saved as npz
     with the packaged 10⁵-word vocabulary, a fresh ``SLAM`` in localization
     mode loads it (keyframe database rebuilt), frame 20 must relocalize
     (≥ 50 inliers, within 0.5 m of ground truth), frames 21-29 must track
     OK through the wide-search window, two blank frames must drive it LOST,
     and frame 30 must relocalize again; each kernel launches exactly once
     on every one of these frames;
  8. RGB-D: ``SLAM(rgbd=True, enable_loop_closing=False)`` at 640×480 with
     the intrinsics, baseline, depth scale, ``th_depth``, ``max_frames`` and
     feature count of ``configs/tum_fr2.yaml`` (zero distortion: the
     renderer is a pinhole) on 20 frames of the default world scaled by 0.15
     so that its depths fall inside ``th_depth · baseline``, as RGB images
     and depth maps in sensor units.  K1 is first held bit-equal to its
     plain version on this one-image canvas; every frame must track OK, the
     ATE must stay under 4% of the path, and each kernel launches exactly
     once a frame;
  9. loop closing: ``SLAM`` with loop closing on at the default
     ``SLAMConfig()`` (1024 keyframe and 262,144 point slots, so the
     essential graph takes the PCG route) on the circle world of
     ``bench_loop.py`` (``circle=True``, ``box_scale=2.5``, period 96): 100
     frames, then the second lap until the background GBA has committed (at
     most 40 more frames), then ``flush()``.  Every frame must track OK, at
     least one loop must close with its edge in ``map.loop_edges``, no GBA
     may be pending after ``flush()``, the live ATE must stay under 5% and
     the final-trajectory ATE under 3% of the path and no worse than the
     live one, and each kernel must launch exactly once a frame.  The
     detection dispatches and the GBA chunks run under
     ``set_sync_debug_mode("error")``; the resolve, the stage gates, the
     correction and the commit under "warn", and the phase prints the reads
     of the closure (warnings plus waits for a copied result), the gates
     of stages A/B/C, each stage's CUDA-event span (the cascade stages,
     ``correct_group``, the fuses, ``optimize_essential``, every GBA chunk,
     the commit), the median frame ms, the largest frame after the closure
     over that median, and peak device memory;
 10. times: per-frame ms of every phase, ms of ``load`` / ``rebuild`` and of
     the relocalizing frames, keyframe-program spans (CUDA events), and each
     kernel's device time at the main-path shapes (``device_ms``:
     back-to-back calls between one event pair, over the count) beside its
     plain version, its bound and, for K2, the one PyTorch call that gathers
     the same windows.

Before the last line come a JSON object with one entry per kernel (launches
summed over the five main-path runs) and the card line; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from orb_slam2_ros2_tpu_torch import SLAMConfig
from orb_slam2_ros2_tpu_torch.bow.keyframe_db import rebuild
from orb_slam2_ros2_tpu_torch.io.synthetic import SyntheticStereoDataset
from orb_slam2_ros2_tpu_torch.io.trajectory import ate_rmse
from orb_slam2_ros2_tpu_torch.ops import _build, fast, patches
from orb_slam2_ros2_tpu_torch.ops.canvas import canvas_layout, padded_canvas_shape
from orb_slam2_ros2_tpu_torch.pipeline.system import SLAM
from orb_slam2_ros2_tpu_torch.pipeline.tracking import TrackState
from orb_slam2_ros2_tpu_torch.solvers import local_ba

N_FRAMES = 10
SPEED = 0.35            # m/frame: the default world tracks at this speed
MAX_TRANS_ERR_M = 0.05
MIN_MEDIAN_INLIERS = 300
FAST_TH = 7.0           # SLAMConfig().orb.min_th_fast
TIMED_RUNS = 100        # back-to-back calls between one event pair
SLEEP_CYCLES = 20_000_000  # device sleep queued ahead of them (~10 ms)
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 ops/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# FAST-9/16 + 3x3 NMS per pixel: 16 ring subtractions, 2 x 47 min/max for the
# best 9-arc of each sign (8 pair-mins and 8 four-run mins at odd starts, 3
# for each of the 8 arc pairs, 7 maxes: csrc/fast_nms.cu best_arc), 1 max of
# the signs, 1 threshold compare, 8 maxes and 1 compare of the 3x3
# suppression
K1_OPS_PER_PIXEL = 16 + 2 * 47 + 1 + 1 + 8 + 1
# device ms of the previous designs, by device_ms on an NVIDIA H100 80GB HBM3
# at 700 W (this script at commit e191f6b): K1 as 8 per-level launches of a
# 32x8-tile kernel, K2 as one block per patch (its design is unchanged)
K1_OLD_MS = 0.11962
K2_OLD_MS = 0.02536
# mapping phase: the KITTI-like world of bench_full.py (facades 10-30 m, sky)
MAP_FRAMES = 40
MAP_SPEED = 0.8
MAP_TH_DEPTH = 60.0
MIN_NEW_KEYFRAMES = 4
MAX_ATE_LIVE = 0.05     # fraction of path length (bench_full.py:153-156)
MAX_ATE_FINAL = 0.03
# relocalization phase, on the mapping run's frames
RELOC_FRAME = 20
RELOC_TRACK_TO = 29     # frames 21-29 track on after the relocalization
RELOC_AGAIN_FRAME = 30
N_BLANK = 2
MIN_RELOC_INLIERS = 50  # TrackingConfig.min_localmap_inliers_reloc
MAX_RELOC_ERR_M = 0.5
# RGB-D phase: configs/tum_fr2.yaml (TUM RGB-D freiburg2) without distortion
TUM_CAMERA = dict(fx=520.908620, fy=521.007327, cx=325.141442, cy=249.701764,
                  baseline=0.0767889, width=640, height=480, camera_type=1, color=1,
                  depth_scale=5208.0)
TUM_TRACKING = dict(th_depth=40.0, max_frames=30)
RGBD_FRAMES = 20
RGBD_WORLD_SCALE = 0.15  # the default world shrunk: walls 1.2 m away, 0.0525 m/frame
MAX_ATE_RGBD = 0.04      # fraction of path length (tests/test_rgbd.py:47)
# loop phase: the circle world of bench_loop.py:38-55 (period 96 frames)
LOOP_FRAMES = 100
LOOP_PERIOD = LOOP_FRAMES - 4
LOOP_EXTRA = 40          # second-lap frames at most, until the GBA commits


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, runs: int = TIMED_RUNS, warmup: int = 5, queue_ahead: bool = True) -> float:
    """Device time of one call of ``fn`` in ms: ``runs`` calls back to back
    between one CUDA event pair, divided by ``runs``.

    With ``queue_ahead`` a device sleep is queued before the start event, so
    the host enqueues every call while the device still sleeps and the pair
    holds no host dispatch; it raises if the host could not get ahead even
    with a longer sleep.  Without it (the plain versions: hundreds of small
    launches a call) host gaps may remain inside the pair.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = SLEEP_CYCLES
    for _ in range(4):
        ev0, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        t0 = time.perf_counter()
        if queue_ahead:
            ev0.record()
            torch.cuda._sleep(cycles)
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        enqueue_ms = (time.perf_counter() - t0) * 1000.0
        end.synchronize()
        if not queue_ahead or enqueue_ms < ev0.elapsed_time(start):
            return start.elapsed_time(end) / runs
        cycles *= 4
    raise AssertionError(f"the host needed {enqueue_ms:.3f} ms to enqueue {runs} calls, "
                         f"longer than the device sleep ahead of them")


def k1_bound_ms(table) -> tuple:
    """(bound ms, what binds) of FAST + 3×3 NMS over the maps of ``table`` on
    the card: each input pixel read once (bf16), each score written once
    (bf16), and K1_OPS_PER_PIXEL operations per pixel at the f32 peak."""
    px = table.out_numel
    t_bytes = 4.0 * px / HBM_BYTES_PER_S
    t_ops = K1_OPS_PER_PIXEL * px / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def k2_windows(canvas, centers):
    """Row and column index grids of every patch window, [N, 48, 1] and
    [N, 1, 64]: ``canvas[rows, cols]`` is the patch gather."""
    y, x = patches._origins(centers.long(), *canvas.shape)
    rows = y[:, None, None] + torch.arange(patches.PATCH_ROWS, device=canvas.device)[None, :, None]
    cols = x[:, None, None] + torch.arange(patches.PATCH_COLS, device=canvas.device)[None, None, :]
    return rows, cols


def k2_bound_ms(canvas, rows, cols) -> tuple:
    """(bound ms, "bytes") of the patch gather: the f32 patches written once
    and the canvas pixels they cover (the union of this run's windows) read
    once; a bf16 → f32 copy has no arithmetic to bind it."""
    cover = torch.zeros(canvas.shape, dtype=torch.bool, device=canvas.device)
    cover[rows, cols] = True
    n_bytes = 2.0 * int(cover.sum()) + 4.0 * rows.shape[0] * patches.PATCH_ROWS * patches.PATCH_COLS
    return n_bytes / HBM_BYTES_PER_S * 1e3, "bytes"


def k1_inputs(cfg: SLAMConfig, gen: torch.Generator, batch: int = 2):
    """bf16 [batch, Hl, Wl] levels at the config's pyramid shapes: uniform
    noise with a flat block, a flat left band and a flat block on the right
    edge (score ties, NMS plateaus, ring wrap at the level's edge); and the
    canvas holding them as the extractor lays it out (2 images for stereo, 1
    for RGB-D), with its table."""
    o, c = cfg.orb, cfg.camera
    row_off, _, shapes = canvas_layout(c.height, c.width, o.n_levels, o.scale_factor)
    rows_p, cols_p = padded_canvas_shape(c.height, c.width, o.n_levels, o.scale_factor)
    levels = []
    canvas = torch.zeros((batch * rows_p, cols_p), dtype=torch.bfloat16, device="cuda")
    for off, (hl, wl) in zip(row_off.tolist(), shapes):
        x = torch.rand((batch, hl, wl), generator=gen, device="cuda") * 255.0
        x[:, hl // 4: hl // 4 + 30, wl // 5: wl // 5 + 70] = 77.0
        x[:, :, :4] = 3.0
        x[:, hl // 2: hl // 2 + 20, wl - 9:] = 140.0
        x = x.to(torch.bfloat16).contiguous()
        levels.append(x)
        for b in range(batch):
            canvas[b * rows_p + off: b * rows_p + off + hl, :wl] = x[b]
    table = fast.pyramid_table(tuple(row_off.tolist()), tuple(shapes), batch, rows_p, cols_p)
    return levels, canvas, table


def k1_check(levels, canvas, table) -> float:
    """Raises unless the kernel, over the whole canvas and level by level,
    equals the plain version of each level; returns the max absolute
    difference seen."""
    err = 0.0
    for nms in (True, False):
        maps = fast.fast_score_nms_pyramid(canvas, table, FAST_TH, nms=nms)
        for x, pyr in zip(levels, maps):
            ker = fast.fast_score_nms(x, FAST_TH, nms=nms)
            ref = fast.fast_score(x, FAST_TH)
            ref = fast.nms3(ref) if nms else ref
            torch.cuda.synchronize()
            for what, got in (("pyramid", pyr), ("one level", ker)):
                if not torch.equal(got, ref):
                    bad = int((got != ref).sum())
                    raise AssertionError(f"fast_nms {what} nms={nms} {tuple(x.shape)}: "
                                         f"{bad} pixels differ")
                err = max(err, float((got.float() - ref.float()).abs().max()))
    return err


def k2_inputs(cfg: SLAMConfig, gen: torch.Generator, batch: int = 2):
    """The canvas (``batch`` padded pyramids stacked: 2 for stereo, 1 for
    RGB-D) and batch·max_keypoints centres: random, plus the four corners,
    clamp edges and out-of-range."""
    o, c = cfg.orb, cfg.camera
    rows, cols = padded_canvas_shape(c.height, c.width, o.n_levels, o.scale_factor)
    H, W = batch * rows, cols
    canvas = (torch.rand((H, W), generator=gen, device="cuda") * 255.0).to(torch.bfloat16)
    n = batch * o.max_keypoints
    ys = torch.randint(0, H, (n,), generator=gen, device="cuda")
    xs = torch.randint(0, W, (n,), generator=gen, device="cuda")
    centers = torch.stack([ys, xs], dim=1).to(torch.int32)
    edges = [[0, 0], [H - 1, W - 1], [0, W - 1], [H - 1, 0], [22, 22],
             [H - 34, W - 234], [H - 33, W - 233], [-5, -5], [H + 9, W + 9]]
    centers[: len(edges)] = torch.tensor(edges, dtype=torch.int32).to("cuda")
    return canvas, centers.contiguous()


def k2_check(canvas, centers) -> float:
    ker = patches.extract_patches_48x64(canvas, centers)
    ref = patches.extract_patches_plain(canvas, centers)
    torch.cuda.synchronize()
    if not torch.equal(ker, ref):
        raise AssertionError(f"patches: {int((ker != ref).sum())} values differ")
    return float((ker - ref).abs().max())


def _reset_launches() -> None:
    fast.fast_nms_launches = 0
    patches.patch_launches = 0


def _launches() -> dict:
    return {"fast_nms": fast.fast_nms_launches, "patches": patches.patch_launches}


def _track(slam: SLAM, label, img_a, img_b):
    """One ``track`` call ended by a synchronise: (pose, stats, ms), after
    checking that it launched each kernel exactly once."""
    before = _launches()
    t0 = time.perf_counter()
    pose, stats = slam.track(img_a, img_b)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1000.0
    k1, k2 = (_launches()[k] - before[k] for k in ("fast_nms", "patches"))
    if k1 != 1 or k2 != 1:
        raise AssertionError(f"frame {label}: kernel launches fast_nms {k1}, patches {k2}; "
                             f"a frame launches each once")
    return pose, stats, ms


def _trans_err(pose, Twc_gt) -> float:
    return float(np.linalg.norm(np.linalg.inv(pose.astype(np.float64))[:3, 3] - Twc_gt[:3, 3]))


def run_slice(cfg: SLAMConfig):
    """Localization-mode tracking of the synthetic sequence; returns the
    per-frame records and the launch counts of the main-path run."""
    ds = SyntheticStereoDataset(cfg.camera, n_frames=N_FRAMES, speed=SPEED, device="cuda")
    frames = [ds.frame(i) for i in range(N_FRAMES)]  # rendered on the card, set-up
    slam = SLAM(cfg, device="cuda")
    torch.cuda.synchronize()

    _reset_launches()
    records = []
    for i, (img_l, img_r, Twc_gt) in enumerate(frames):
        slam.frame_sync_debug_mode = "error" if i >= 2 else None
        pose, stats, ms = _track(slam, i, img_l, img_r)
        if slam.state != TrackState.OK or pose is None:
            raise AssertionError(f"frame {i}: state {slam.state}, stats {stats}")
        err = _trans_err(pose, Twc_gt)
        rec = dict(frame=i, ms=ms, trans_err_m=err, n_inliers=stats.get("n_inliers"),
                   n_tracked=stats.get("n_tracked"), n_mappoints=stats.get("n_mappoints"))
        print(f"[5/10] frame {i}: {json.dumps(rec)}", flush=True)
        if err > MAX_TRANS_ERR_M:
            raise AssertionError(f"frame {i}: translation error {err:.4f} m > {MAX_TRANS_ERR_M}")
        records.append(rec)
    launches = _launches()
    slam.frame_sync_debug_mode = None
    med = statistics.median(r["n_inliers"] for r in records[1:])
    if med < MIN_MEDIAN_INLIERS:
        raise AssertionError(f"median n_inliers {med} < {MIN_MEDIAN_INLIERS}")
    return records, launches, med


def run_mapping(cfg: SLAMConfig):
    """Full SLAM (keyframes, mapping, local BA; no loop closing) over the
    KITTI-like synthetic sequence.  Returns (per-frame records, launch
    counts of the main-path run, summary)."""
    ds = SyntheticStereoDataset(cfg.camera, n_frames=MAP_FRAMES + 2, speed=MAP_SPEED,
                                box_scale=2.5, sky=True, device="cuda")
    frames = [ds.frame(i) for i in range(MAP_FRAMES)]  # rendered on the card, set-up
    gt_twc = {i: g for i, (_, _, g) in enumerate(frames)}
    slam = SLAM(cfg, enable_loop_closing=False, device="cuda")
    slam.time_programs = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _reset_launches()
    local_ba.local_ba_runs = 0
    records = []
    for i, (img_l, img_r, _) in enumerate(frames):
        n_kf_before = slam._n_kf
        slam.frame_sync_debug_mode = "error" if i >= 2 else None
        pose, stats, ms = _track(slam, i, img_l, img_r)
        if slam.state != TrackState.OK or pose is None:
            raise AssertionError(f"frame {i}: state {slam.state}, stats {stats}")
        rec = dict(frame=i, ms=ms, keyframe=slam._n_kf > n_kf_before,
                   n_inliers=stats.get("n_inliers"), n_tracked=stats.get("n_tracked"),
                   n_kf=slam._n_kf, next_mp=stats.get("next_mp"))
        print(f"[6/10] frame {i}: {json.dumps(rec)}", flush=True)
        records.append(rec)
    slam.flush()
    torch.cuda.synchronize()
    slam.frame_sync_debug_mode = None
    launches = _launches()

    new_kfs = sum(r["keyframe"] for r in records[1:])
    if new_kfs < MIN_NEW_KEYFRAMES:
        raise AssertionError(f"{new_kfs} keyframes inserted after keyframe 0 < {MIN_NEW_KEYFRAMES}")
    if local_ba.local_ba_runs < 1:
        raise AssertionError("no local BA ran")

    def ate(pairs):
        return ate_rmse([np.linalg.inv(T.astype(np.float64)) for _, T in pairs],
                        [gt_twc[f] for f, _ in pairs])

    path_len = float(sum(np.linalg.norm(gt_twc[i + 1][:3, 3] - gt_twc[i][:3, 3])
                         for i in range(MAP_FRAMES - 1)))
    ate_live, ate_final = ate(slam.trajectory), ate(slam.final_trajectory())
    spans = {}
    for name, start, end in slam.program_events:
        spans.setdefault(name, []).append(start.elapsed_time(end))
    summary = dict(
        new_keyframes=new_kfs, local_ba_runs=local_ba.local_ba_runs,
        n_keyframes=slam.n_keyframes, n_mappoints=slam.n_mappoints,
        ate_live_m=ate_live, ate_final_m=ate_final, path_len_m=path_len,
        peak_mem_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
        program_span_ms={k: dict(n=len(v), median=statistics.median(v), max=max(v))
                         for k, v in spans.items()},
    )
    print(f"[6/10] mapping: {json.dumps(summary)}", flush=True)
    if not ate_live < MAX_ATE_LIVE * path_len:
        raise AssertionError(f"live ATE {ate_live:.4f} m ≥ {MAX_ATE_LIVE} × {path_len:.2f} m")
    if not ate_final < MAX_ATE_FINAL * path_len:
        raise AssertionError(f"final ATE {ate_final:.4f} m ≥ {MAX_ATE_FINAL} × {path_len:.2f} m")
    return records, launches, summary, slam, frames


def run_relocalization(map_slam: SLAM, cfg: SLAMConfig, frames):
    """Localize in the map the mapping run built: save it with its
    vocabulary, load it into a fresh localization-mode ``SLAM``, relocalize,
    track on, lose track on blank frames and relocalize again.  Returns
    (records, launch counts of the run, summary)."""
    map_slam._ensure_loop_closer(map_slam.ref_kf)   # the packaged 10x5 vocabulary
    vocab = map_slam.loop_closer.vocab
    if vocab.n_words != 10 ** 5:
        raise AssertionError(f"the default BoWConfig resolved a {vocab.n_words}-word vocabulary")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "map")
        t0 = time.perf_counter()
        map_slam.save(path)
        save_ms = (time.perf_counter() - t0) * 1000.0
        file_mib = sum(os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp)) / 2 ** 20
        slam = SLAM(cfg, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slam.load(path)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1000.0
    if slam.n_keyframes != map_slam.n_keyframes or slam.loop_closer is None:
        raise AssertionError("the loaded map differs from the saved one")
    t0 = time.perf_counter()
    db = rebuild(slam.loop_closer.vocab, slam.map, max_words=cfg.bow.max_words_per_query)
    torch.cuda.synchronize()
    rebuild_ms = (time.perf_counter() - t0) * 1000.0
    if not torch.equal(db.word_ids, slam.loop_closer.db.word_ids):
        raise AssertionError("rebuild is not reproducible")

    blank = torch.zeros_like(frames[0][0])
    plan = ([("reloc", RELOC_FRAME)]
            + [("track", i) for i in range(RELOC_FRAME + 1, RELOC_TRACK_TO + 1)]
            + [("blank", None)] * N_BLANK + [("reloc", RELOC_AGAIN_FRAME)])
    _reset_launches()
    records = []
    for n, (kind, i) in enumerate(plan):
        # the frame program of the tracked frames runs without host syncs
        slam.frame_sync_debug_mode = "error" if kind == "track" and n >= 2 else None
        img_l, img_r, Twc_gt = frames[i] if i is not None else (blank, blank, None)
        pose, stats, ms = _track(slam, f"{kind} {i}", img_l, img_r)
        rec = dict(kind=kind, frame=i, ms=ms, state=slam.state.name,
                   n_inliers=stats.get("n_inliers"), reloc_kf=stats.get("reloc_kf"),
                   reloc_candidates=stats.get("reloc_candidates"),
                   trans_err_m=None if pose is None else _trans_err(pose, Twc_gt))
        print(f"[7/10] {json.dumps(rec)}", flush=True)
        if kind == "blank":
            if pose is not None or slam.state != TrackState.LOST:
                raise AssertionError(f"blank frame: state {slam.state}, stats {stats}")
        else:
            if pose is None or slam.state != TrackState.OK:
                raise AssertionError(f"{kind} frame {i}: state {slam.state}, stats {stats}")
            if rec["trans_err_m"] > MAX_RELOC_ERR_M:
                raise AssertionError(f"{kind} frame {i}: {rec['trans_err_m']:.3f} m from ground truth")
            if kind == "reloc" and not (stats.get("relocalized") and stats["n_inliers"] >= MIN_RELOC_INLIERS):
                raise AssertionError(f"frame {i} did not relocalize: {stats}")
        records.append(rec)
    slam.frame_sync_debug_mode = None
    if slam.n_keyframes != map_slam.n_keyframes:
        raise AssertionError("localization mode inserted a keyframe")
    summary = dict(save_ms=save_ms, load_ms=load_ms, rebuild_ms=rebuild_ms, map_files_mib=file_mib,
                   n_keyframes=slam.n_keyframes, kf_capacity=slam.map.kf_capacity,
                   n_words=vocab.n_words,
                   reloc_ms=[r["ms"] for r in records if r["kind"] == "reloc"],
                   lost_ms=[r["ms"] for r in records if r["kind"] == "blank"],
                   track_ms_median=statistics.median(r["ms"] for r in records if r["kind"] == "track"))
    return records, _launches(), summary


def rgbd_config(base: SLAMConfig) -> SLAMConfig:
    return base.replace(
        camera=dataclasses.replace(base.camera, **TUM_CAMERA),
        tracking=dataclasses.replace(base.tracking, **TUM_TRACKING),
    )


def run_rgbd(cfg: SLAMConfig):
    """RGB-D SLAM (no loop closing) at the TUM fr2 size: RGB images and
    depth maps in sensor units of the default world shrunk by
    ``RGBD_WORLD_SCALE``.  Returns (records, launch counts, summary)."""
    ds = SyntheticStereoDataset(cfg.camera, n_frames=RGBD_FRAMES, speed=SPEED, device="cuda")
    frames = []
    for i in range(RGBD_FRAMES):  # rendered on the card, set-up
        img, depth, Twc = ds.frame_with_depth(i)
        Twc = Twc.copy()
        Twc[:3, 3] *= RGBD_WORLD_SCALE
        frames.append((img[:, :, None].expand(-1, -1, 3).contiguous(),
                       depth * (RGBD_WORLD_SCALE * cfg.camera.depth_scale), Twc))
    slam = SLAM(cfg, rgbd=True, enable_loop_closing=False, device="cuda")
    torch.cuda.synchronize()

    _reset_launches()
    records = []
    for i, (rgb, depth, Twc_gt) in enumerate(frames):
        n_kf_before = slam._n_kf
        slam.frame_sync_debug_mode = "error" if i >= 2 else None
        pose, stats, ms = _track(slam, i, rgb, depth)
        if slam.state != TrackState.OK or pose is None:
            raise AssertionError(f"frame {i}: state {slam.state}, stats {stats}")
        rec = dict(frame=i, ms=ms, keyframe=slam._n_kf > n_kf_before, n_inliers=stats.get("n_inliers"),
                   n_kf=slam._n_kf, n_mappoints=stats.get("n_mappoints"),
                   trans_err_m=_trans_err(pose, Twc_gt))
        print(f"[8/10] frame {i}: {json.dumps(rec)}", flush=True)
        records.append(rec)
    slam.flush()
    torch.cuda.synchronize()
    slam.frame_sync_debug_mode = None
    launches = _launches()
    gt = [f[2] for f in frames]
    ate = ate_rmse([np.linalg.inv(T.astype(np.float64)) for _, T in slam.trajectory], gt)
    path_len = float(sum(np.linalg.norm(gt[i + 1][:3, 3] - gt[i][:3, 3]) for i in range(RGBD_FRAMES - 1)))
    summary = dict(ate_m=ate, path_len_m=path_len, n_keyframes=slam.n_keyframes,
                   n_mappoints=slam.n_mappoints, init_mappoints=records[0]["n_mappoints"])
    if not ate < MAX_ATE_RGBD * path_len:
        raise AssertionError(f"RGB-D ATE {ate:.4f} m ≥ {MAX_ATE_RGBD} × {path_len:.3f} m")
    return records, launches, summary


def _span_ms(slam: SLAM) -> dict:
    """CUDA-event spans of the SLAM's programs by name: [ms, ...]."""
    spans: dict = {}
    for name, start, end in slam.program_events:
        spans.setdefault(name, []).append(start.elapsed_time(end))
    return spans


def run_loop(cfg: SLAMConfig):
    """Full SLAM with loop closing around the circle world: the first lap,
    then the second lap (bench_loop.py's index rule) until the background
    GBA has committed, at most LOOP_EXTRA frames, then ``flush()``.  The
    detection dispatches and GBA chunks run under sync debug "error"; the
    stages that may read back run under "warn", and a frame's reads are its
    warnings plus its waits for a gate or detection copy (the debug mode
    does not see event waits).  Returns (records, launch counts, summary)."""
    ds = SyntheticStereoDataset(cfg.camera, n_frames=LOOP_FRAMES, circle=True, box_scale=2.5,
                                device="cuda")
    frames = [ds.frame(i) for i in range(LOOP_FRAMES)]  # rendered on the card, set-up
    slam = SLAM(cfg, device="cuda")
    slam.time_programs = True
    slam.loop_sync_debug_mode = "warn"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _reset_launches()
    records, gt = [], []
    closure_frame, commit_frame, cascade_start, closure_start = None, None, None, None
    i = 0
    while True:
        if i < LOOP_FRAMES:
            j = i
        elif closure_frame is not None and slam._pending_gba is None:
            break
        elif i >= LOOP_FRAMES + LOOP_EXTRA:
            break
        else:
            j = ((i - 4) % LOOP_PERIOD) + 4
        img_l, img_r, Twc_gt = frames[j]
        n_events, loops = len(slam.program_events), slam.loops_closed
        waits = slam.loop_closer.host_reads if slam.loop_closer is not None else 0
        slam.frame_sync_debug_mode = "error" if i >= 2 else None
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            pose, stats, ms = _track(slam, i, img_l, img_r)
        if slam.state != TrackState.OK or pose is None:
            raise AssertionError(f"loop frame {i}: state {slam.state}, stats {stats}")
        stages = sorted({name for name, _, _ in slam.program_events[n_events:]})
        reads = (sum("synchroniz" in str(w.message) for w in caught)
                 + (slam.loop_closer.host_reads - waits if slam.loop_closer is not None else 0))
        if "sim3_a" in stages:
            cascade_start = i
        if slam.loops_closed > loops:
            closure_frame, closure_start = i, cascade_start
        if "gba_commit" in stages:
            commit_frame = i
        rec = dict(frame=i, src=j, ms=ms, n_kf=slam._n_kf, n_inliers=stats.get("n_inliers"),
                   reads=reads, stages=stages, loops=slam.loops_closed)
        print(f"[9/10] frame {i}: {json.dumps(rec)}", flush=True)
        records.append(rec)
        gt.append(Twc_gt)
        i += 1
    slam.flush()
    torch.cuda.synchronize()
    slam.frame_sync_debug_mode = None
    launches = _launches()

    loop_edges = slam.map.loop_edges.cpu().numpy()
    edges = loop_edges[loop_edges[:, 0] >= 0].tolist()
    if slam.loops_closed < 1 or not edges:
        raise AssertionError(f"no loop closed: loops_closed {slam.loops_closed}, loop edges {edges}, "
                             f"gates {slam.loop_closer.gate_log if slam.loop_closer else None}")
    if slam._pending_gba is not None:
        raise AssertionError("the background GBA is still pending after flush()")

    def ate(pairs):
        return ate_rmse([np.linalg.inv(T.astype(np.float64)) for _, T in pairs], [gt[f] for f, _ in pairs])

    path_len = float(sum(np.linalg.norm(gt[k + 1][:3, 3] - gt[k][:3, 3]) for k in range(len(gt) - 1)))
    ate_live, ate_final = ate(slam.trajectory), ate(slam.final_trajectory())
    spans = _span_ms(slam)
    ms_all = [r["ms"] for r in records]
    med = statistics.median(ms_all[10:])
    after = ms_all[closure_frame:] if closure_frame is not None else []
    last = commit_frame if commit_frame is not None else len(records) - 1
    closure_reads = (sum(r["reads"] for r in records[closure_start:last + 1])
                     if closure_start is not None else None)
    summary = dict(
        frames=len(records), closure_frame=closure_frame, cascade_start_frame=closure_start,
        commit_frame=commit_frame, loop_edges=edges, loops_closed=slam.loops_closed,
        gates=[g for g in slam.loop_closer.gate_log],
        n_keyframes=slam.n_keyframes, n_mappoints=slam.n_mappoints,
        ate_live_m=ate_live, ate_final_m=ate_final, path_len_m=path_len,
        median_frame_ms=med, max_after_closure_ms=max(after) if after else None,
        spike_ratio=max(after) / med if after else None,
        reads_closure=closure_reads, reads_by_frame={r["frame"]: r["reads"] for r in records if r["reads"]},
        peak_mem_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
        span_ms={k: [round(x, 3) for x in v] for k, v in spans.items()
                 if k not in ("map_front", "map_tail", "cull_kfs", "loop_detect")},
        keyframe_span_ms={k: dict(n=len(spans[k]), median=statistics.median(spans[k]), max=max(spans[k]))
                          for k in ("map_front", "map_tail", "cull_kfs", "loop_detect") if k in spans},
    )
    print(f"[9/10] loop: {json.dumps(summary)}", flush=True)
    if not ate_live < MAX_ATE_LIVE * path_len:
        raise AssertionError(f"loop live ATE {ate_live:.4f} m ≥ {MAX_ATE_LIVE} × {path_len:.2f} m")
    if not ate_final < MAX_ATE_FINAL * path_len:
        raise AssertionError(f"loop final ATE {ate_final:.4f} m ≥ {MAX_ATE_FINAL} × {path_len:.2f} m")
    if not ate_final <= ate_live:
        raise AssertionError(f"loop final ATE {ate_final:.4f} m worse than live {ate_live:.4f} m")
    return records, launches, summary


def _frame_ms(records, keyframe=None):
    ms = [r["ms"] for r in records[2:] if keyframe is None or r["keyframe"] == keyframe]
    return statistics.median(ms) if ms else float("nan")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    card = gpu_line()
    print(f"[1/10] device: {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"[2/10] build: {build_s:.3f} s total, nvcc {json.dumps(_build.build_seconds)}", flush=True)
    for name in _build.SIGNATURES:
        log = _build.BUILD_DIR / f"{name}.ptxas.log"
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"      {name}: {line.strip()}")

    base = SLAMConfig()
    cfg = base.replace(tracking=dataclasses.replace(base.tracking, only_tracking=True))
    map_cfg = base.replace(tracking=dataclasses.replace(base.tracking, th_depth=MAP_TH_DEPTH))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    levels, k1_canvas, k1_table = k1_inputs(cfg, gen)
    k1_err = k1_check(levels, k1_canvas, k1_table)
    print(f"[3/10] fast_nms: one launch over the canvas {tuple(k1_canvas.shape)} and one per "
          f"level, bit-equal to nms3(fast_score) on {len(levels)} levels "
          f"{[tuple(x.shape) for x in levels]}, nms on and off", flush=True)
    canvas, centers = k2_inputs(cfg, gen)
    k2_err = k2_check(canvas, centers)
    print(f"[4/10] patches: bit-equal to extract_patches_plain, canvas {tuple(canvas.shape)}, "
          f"{centers.shape[0]} centres", flush=True)

    records, launches, med = run_slice(cfg)
    print(f"[5/10] localization: {N_FRAMES} frames OK, median n_inliers(1-9) {med}, "
          f"max trans err {max(r['trans_err_m'] for r in records):.4f} m, launches {launches}",
          flush=True)
    map_records, map_launches, summary, map_slam, map_frames = run_mapping(map_cfg)
    print(f"[6/10] mapping: {MAP_FRAMES} frames OK, {summary['new_keyframes']} keyframes after "
          f"keyframe 0, {summary['local_ba_runs']} local BAs, ATE live {summary['ate_live_m']:.4f} m "
          f"final {summary['ate_final_m']:.4f} m on a {summary['path_len_m']:.2f} m path, "
          f"launches {map_launches}", flush=True)

    reloc_cfg = map_cfg.replace(tracking=dataclasses.replace(map_cfg.tracking, only_tracking=True))
    reloc_records, reloc_launches, reloc = run_relocalization(map_slam, reloc_cfg, map_frames)
    print(f"[7/10] relocalization: {json.dumps(reloc)}, launches {reloc_launches}", flush=True)
    del map_slam, map_frames

    rgbd_cfg = rgbd_config(base)
    r_levels, r_canvas, r_table = k1_inputs(rgbd_cfg, gen, batch=1)
    k1_err = max(k1_err, k1_check(r_levels, r_canvas, r_table))
    r2_canvas, r2_centers = k2_inputs(rgbd_cfg, gen, batch=1)
    k2_err = max(k2_err, k2_check(r2_canvas, r2_centers))
    print(f"[8/10] RGB-D kernels: fast_nms bit-equal on the one-image canvas {tuple(r_canvas.shape)} "
          f"(one launch, and per level, nms on and off), patches bit-equal with "
          f"{r2_centers.shape[0]} centres", flush=True)
    rgbd_records, rgbd_launches, rgbd = run_rgbd(rgbd_cfg)
    print(f"[8/10] RGB-D: {RGBD_FRAMES} frames OK, {json.dumps(rgbd)}, launches {rgbd_launches}",
          flush=True)

    _, loop_launches, loop = run_loop(base)
    print(f"[9/10] loop closing: {loop['frames']} frames OK, closure at frame {loop['closure_frame']} "
          f"(edges {loop['loop_edges']}), GBA committed at frame {loop['commit_frame']}, ATE live "
          f"{loop['ate_live_m']:.4f} m final {loop['ate_final_m']:.4f} m on a {loop['path_len_m']:.2f} m "
          f"path, median frame {loop['median_frame_ms']:.1f} ms, spike ratio {loop['spike_ratio']}, "
          f"reads in the closure {loop['reads_closure']}, peak device memory "
          f"{loop['peak_mem_mib']:.1f} MiB, launches {loop_launches}", flush=True)

    k1_out = torch.empty(k1_table.out_numel, dtype=torch.bfloat16, device="cuda")
    k1_ms = device_ms(lambda: fast.fast_score_nms_pyramid(k1_canvas, k1_table, FAST_TH, out=k1_out))
    k1_plain = device_ms(lambda: [fast.nms3(fast.fast_score(x, FAST_TH)) for x in levels],
                         runs=10, queue_ahead=False)
    k1_bound, k1_by = k1_bound_ms(k1_table)
    k2_out = torch.empty((centers.shape[0], patches.PATCH_ROWS, patches.PATCH_COLS),
                         dtype=torch.float32, device="cuda")
    k2_ms = device_ms(lambda: patches.extract_patches_48x64(canvas, centers, out=k2_out))
    k2_plain = device_ms(lambda: patches.extract_patches_plain(canvas, centers),
                         runs=20, queue_ahead=False)
    rows, cols = k2_windows(canvas, centers)
    k2_lib = device_ms(lambda: canvas[rows, cols])
    k2_bound, k2_by = k2_bound_ms(canvas, rows, cols)
    print(f"[10/10] localization frame ms (frames 2-{N_FRAMES - 1}): median {_frame_ms(records):.3f}, "
          f"all {[round(r['ms'], 3) for r in records[2:]]} | mapping frame ms (frames ≥ 2): "
          f"keyframe median {_frame_ms(map_records, True):.3f}, other median "
          f"{_frame_ms(map_records, False):.3f} | keyframe-program spans "
          f"{json.dumps(summary['program_span_ms'])} | peak device memory "
          f"{summary['peak_mem_mib']:.1f} MiB", flush=True)
    r_out = torch.empty(r_table.out_numel, dtype=torch.bfloat16, device="cuda")
    k1_rgbd_ms = device_ms(lambda: fast.fast_score_nms_pyramid(r_canvas, r_table, FAST_TH, out=r_out))
    r2_out = torch.empty((r2_centers.shape[0], patches.PATCH_ROWS, patches.PATCH_COLS),
                         dtype=torch.float32, device="cuda")
    k2_rgbd_ms = device_ms(lambda: patches.extract_patches_48x64(r2_canvas, r2_centers, out=r2_out))
    print(f"[10/10] relocalization ms: save {reloc['save_ms']:.1f}, load (with rebuild) "
          f"{reloc['load_ms']:.1f}, rebuild alone {reloc['rebuild_ms']:.1f} "
          f"({reloc['kf_capacity']} slots, {reloc['n_words']} words), relocalizing frames "
          f"{[round(x, 1) for x in reloc['reloc_ms']]}, LOST frames "
          f"{[round(x, 1) for x in reloc['lost_ms']]}, tracked frames median "
          f"{reloc['track_ms_median']:.1f} | RGB-D frame ms (frames ≥ 2): keyframe median "
          f"{_frame_ms(rgbd_records, True):.3f}, other median {_frame_ms(rgbd_records, False):.3f} | "
          f"device ms on the RGB-D canvas: fast_nms {k1_rgbd_ms:.5f} (bound "
          f"{k1_bound_ms(r_table)[0] * 1e3:.3f} us), patches {k2_rgbd_ms:.5f}", flush=True)
    print(f"[10/10] device ms per call ({TIMED_RUNS} back-to-back): fast_nms (8 levels x 2 images, "
          f"one launch) {k1_ms:.5f} (per-level design {K1_OLD_MS}) vs plain {k1_plain:.4f}, bound "
          f"{k1_bound * 1e3:.3f} us ({k1_by}), share {k1_bound / k1_ms:.3f} | patches {k2_ms:.5f} "
          f"(before {K2_OLD_MS}) vs plain {k2_plain:.4f}, library canvas[rows, cols] {k2_lib:.5f}, "
          f"bound {k2_bound * 1e3:.3f} us ({k2_by}), share {k2_bound / k2_ms:.3f}", flush=True)

    runs_launches = (launches, map_launches, reloc_launches, rgbd_launches, loop_launches)
    kernels = [
        {"name": "fast_nms", "route": "cuda", "source": "orb_slam2_ros2_tpu_torch/csrc/fast_nms.cu",
         "replaces": "orb_slam2_ros2_tpu/ops/pallas_fast.py:109",
         "launches": sum(x["fast_nms"] for x in runs_launches),
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None, "bound_us": k1_bound * 1e3,
         "share": k1_bound / k1_ms},
        {"name": "patches", "route": "cuda", "source": "orb_slam2_ros2_tpu_torch/csrc/patches.cu",
         "replaces": "orb_slam2_ros2_tpu/ops/pallas_patches.py:116",
         "launches": sum(x["patches"] for x in runs_launches),
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": k2_lib, "bound_us": k2_bound * 1e3,
         "share": k2_bound / k2_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
