#!/usr/bin/env python3
"""Drive the PyTorch port's stereo SLAM paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (one line each; any failure raises and exits non-zero):
  1. the card (nvidia-smi name and power limit); no CUDA device → exit 1;
  2. build every CUDA kernel from ``orb_slam2_ros2_tpu_torch/csrc`` (nvcc);
  3. K1 ``fast_nms`` against its plain PyTorch version at the 8 KITTI pyramid
     level shapes, batch 2, NMS on and off — bit-equal (``torch.equal``);
  4. K2 ``patches`` against its plain version on the KITTI stereo canvas with
     4096 centres, corners and clamp edges included — bit-equal;
  5. localization: ``SLAM`` in localization mode at the full KITTI width of
     the default ``SLAMConfig`` on 10 synthetic stereo frames rendered on
     the card.  Every frame must track OK within 0.05 m of ground truth, the
     median inlier count over frames 1-9 must reach 300, both kernels must
     launch on every frame, and frames 2-9 run the frame program under
     ``torch.cuda.set_sync_debug_mode("error")``;
  6. mapping: ``SLAM(enable_loop_closing=False)`` in the default mode (full
     SLAM, deferred mapping tail) at the default ``SLAMConfig`` with
     ``th_depth=60`` on 40 frames of the KITTI-like world (``box_scale=2.5``,
     sky, 0.8 m/frame).  Every frame must track OK, ≥ 4 keyframes must be
     inserted after keyframe 0, ≥ 1 local BA must run, after ``flush()`` the
     live ATE must stay under 5% and the final-trajectory ATE under 3% of
     the path length, both kernels must launch on every frame, and frames
     ≥ 2 — keyframe programs included — run under
     ``set_sync_debug_mode("error")``;
  7. times: per-frame ms of both phases, keyframe-program spans (CUDA
     events), and each kernel against its plain version at the main-path
     shapes (CUDA events, median of 20 runs).

Before the last line come a JSON object with one entry per kernel (launches
summed over the localization and mapping runs) and the card line; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from orb_slam2_ros2_tpu_torch import SLAMConfig
from orb_slam2_ros2_tpu_torch.io.synthetic import SyntheticStereoDataset
from orb_slam2_ros2_tpu_torch.io.trajectory import ate_rmse
from orb_slam2_ros2_tpu_torch.ops import _build, fast, patches
from orb_slam2_ros2_tpu_torch.ops.canvas import padded_canvas_shape
from orb_slam2_ros2_tpu_torch.ops.pyramid import level_shapes
from orb_slam2_ros2_tpu_torch.pipeline.system import SLAM
from orb_slam2_ros2_tpu_torch.pipeline.tracking import TrackState
from orb_slam2_ros2_tpu_torch.solvers import local_ba

N_FRAMES = 10
SPEED = 0.35            # m/frame: the default world tracks at this speed
MAX_TRANS_ERR_M = 0.05
MIN_MEDIAN_INLIERS = 300
FAST_TH = 7.0           # SLAMConfig().orb.min_th_fast
TIMING_RUNS = 20
# mapping phase: the KITTI-like world of bench_full.py (facades 10-30 m, sky)
MAP_FRAMES = 40
MAP_SPEED = 0.8
MAP_TH_DEPTH = 60.0
MIN_NEW_KEYFRAMES = 4
MAX_ATE_LIVE = 0.05     # fraction of path length (bench_full.py:153-156)
MAX_ATE_FINAL = 0.03


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int = TIMING_RUNS, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms over ``runs`` CUDA-event-timed calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def k1_inputs(cfg: SLAMConfig, gen: torch.Generator):
    """bf16 [2, Hl, Wl] levels at the config's pyramid shapes: uniform noise
    with a flat block and a flat left band (score ties, NMS plateaus)."""
    o, c = cfg.orb, cfg.camera
    levels = []
    for hl, wl in level_shapes(c.height, c.width, o.n_levels, o.scale_factor):
        x = torch.rand((2, hl, wl), generator=gen, device="cuda") * 255.0
        x[:, hl // 4: hl // 4 + 30, wl // 5: wl // 5 + 70] = 77.0
        x[:, :, :4] = 3.0
        levels.append(x.to(torch.bfloat16).contiguous())
    return levels


def k1_check(levels) -> float:
    """Raises unless the kernel equals the plain version; returns the max
    absolute difference seen."""
    err = 0.0
    for nms in (True, False):
        for x in levels:
            ker = fast.fast_score_nms(x, FAST_TH, nms=nms)
            ref = fast.fast_score(x, FAST_TH)
            ref = fast.nms3(ref) if nms else ref
            torch.cuda.synchronize()
            if not torch.equal(ker, ref):
                bad = int((ker != ref).sum())
                raise AssertionError(f"fast_nms nms={nms} {tuple(x.shape)}: {bad} pixels differ")
            err = max(err, float((ker.float() - ref.float()).abs().max()))
    return err


def k2_inputs(cfg: SLAMConfig, gen: torch.Generator):
    """The stereo canvas (two padded pyramids stacked) and 2·max_keypoints
    centres: random, plus the four corners, clamp edges and out-of-range."""
    o, c = cfg.orb, cfg.camera
    rows, cols = padded_canvas_shape(c.height, c.width, o.n_levels, o.scale_factor)
    H, W = 2 * rows, cols
    canvas = (torch.rand((H, W), generator=gen, device="cuda") * 255.0).to(torch.bfloat16)
    n = 2 * o.max_keypoints
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


def _check_launches(i: int, cfg: SLAMConfig, k1: int, k2: int) -> None:
    if k1 < cfg.orb.n_levels or k2 < 1:
        raise AssertionError(f"frame {i}: kernel launches {k1}/{k2}")


def run_slice(cfg: SLAMConfig):
    """Localization-mode tracking of the synthetic sequence; returns the
    per-frame records and the launch counts of the main-path run."""
    ds = SyntheticStereoDataset(cfg.camera, n_frames=N_FRAMES, speed=SPEED, device="cuda")
    frames = [ds.frame(i) for i in range(N_FRAMES)]  # rendered on the card, set-up
    slam = SLAM(cfg, device="cuda")
    torch.cuda.synchronize()

    fast.fast_nms_launches = 0
    patches.patch_launches = 0
    records = []
    for i, (img_l, img_r, Twc_gt) in enumerate(frames):
        k1_before, k2_before = fast.fast_nms_launches, patches.patch_launches
        slam.frame_sync_debug_mode = "error" if i >= 2 else None
        t0 = time.perf_counter()
        pose, stats = slam.track(img_l, img_r)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1000.0
        if slam.state != TrackState.OK or pose is None:
            raise AssertionError(f"frame {i}: state {slam.state}, stats {stats}")
        t_est = np.linalg.inv(pose.astype(np.float64))[:3, 3]
        err = float(np.linalg.norm(t_est - Twc_gt[:3, 3]))
        rec = dict(frame=i, ms=ms, trans_err_m=err, n_inliers=stats.get("n_inliers"),
                   n_tracked=stats.get("n_tracked"), n_mappoints=stats.get("n_mappoints"),
                   fast_nms=fast.fast_nms_launches - k1_before,
                   patches=patches.patch_launches - k2_before)
        print(f"[5/7] frame {i}: {json.dumps(rec)}", flush=True)
        if err > MAX_TRANS_ERR_M:
            raise AssertionError(f"frame {i}: translation error {err:.4f} m > {MAX_TRANS_ERR_M}")
        _check_launches(i, cfg, rec["fast_nms"], rec["patches"])
        records.append(rec)
    launches = {"fast_nms": fast.fast_nms_launches, "patches": patches.patch_launches}
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

    fast.fast_nms_launches = 0
    patches.patch_launches = 0
    local_ba.local_ba_runs = 0
    records = []
    for i, (img_l, img_r, _) in enumerate(frames):
        k1_before, k2_before = fast.fast_nms_launches, patches.patch_launches
        n_kf_before = slam._n_kf
        slam.frame_sync_debug_mode = "error" if i >= 2 else None
        t0 = time.perf_counter()
        pose, stats = slam.track(img_l, img_r)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1000.0
        if slam.state != TrackState.OK or pose is None:
            raise AssertionError(f"frame {i}: state {slam.state}, stats {stats}")
        rec = dict(frame=i, ms=ms, keyframe=slam._n_kf > n_kf_before,
                   n_inliers=stats.get("n_inliers"), n_tracked=stats.get("n_tracked"),
                   n_kf=slam._n_kf, next_mp=stats.get("next_mp"),
                   fast_nms=fast.fast_nms_launches - k1_before,
                   patches=patches.patch_launches - k2_before)
        print(f"[6/7] frame {i}: {json.dumps(rec)}", flush=True)
        _check_launches(i, cfg, rec["fast_nms"], rec["patches"])
        records.append(rec)
    slam.flush()
    torch.cuda.synchronize()
    slam.frame_sync_debug_mode = None
    launches = {"fast_nms": fast.fast_nms_launches, "patches": patches.patch_launches}

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
    print(f"[6/7] mapping: {json.dumps(summary)}", flush=True)
    if not ate_live < MAX_ATE_LIVE * path_len:
        raise AssertionError(f"live ATE {ate_live:.4f} m ≥ {MAX_ATE_LIVE} × {path_len:.2f} m")
    if not ate_final < MAX_ATE_FINAL * path_len:
        raise AssertionError(f"final ATE {ate_final:.4f} m ≥ {MAX_ATE_FINAL} × {path_len:.2f} m")
    return records, launches, summary


def _frame_ms(records, keyframe=None):
    ms = [r["ms"] for r in records[2:] if keyframe is None or r["keyframe"] == keyframe]
    return statistics.median(ms) if ms else float("nan")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    card = gpu_line()
    print(f"[1/7] device: {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"[2/7] build: {build_s:.3f} s total, nvcc {json.dumps(_build.build_seconds)}", flush=True)
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

    levels = k1_inputs(cfg, gen)
    k1_err = k1_check(levels)
    print(f"[3/7] fast_nms: bit-equal to nms3(fast_score) on {len(levels)} levels "
          f"{[tuple(x.shape) for x in levels]}, nms on and off", flush=True)
    canvas, centers = k2_inputs(cfg, gen)
    k2_err = k2_check(canvas, centers)
    print(f"[4/7] patches: bit-equal to extract_patches_plain, canvas {tuple(canvas.shape)}, "
          f"{centers.shape[0]} centres", flush=True)

    records, launches, med = run_slice(cfg)
    print(f"[5/7] localization: {N_FRAMES} frames OK, median n_inliers(1-9) {med}, "
          f"max trans err {max(r['trans_err_m'] for r in records):.4f} m, launches {launches}",
          flush=True)
    map_records, map_launches, summary = run_mapping(map_cfg)
    print(f"[6/7] mapping: {MAP_FRAMES} frames OK, {summary['new_keyframes']} keyframes after "
          f"keyframe 0, {summary['local_ba_runs']} local BAs, ATE live {summary['ate_live_m']:.4f} m "
          f"final {summary['ate_final_m']:.4f} m on a {summary['path_len_m']:.2f} m path, "
          f"launches {map_launches}", flush=True)

    k1_ms = cuda_ms(lambda: [fast.fast_score_nms(x, FAST_TH) for x in levels])
    k1_plain = cuda_ms(lambda: [fast.nms3(fast.fast_score(x, FAST_TH)) for x in levels])
    k2_ms = cuda_ms(lambda: patches.extract_patches_48x64(canvas, centers))
    k2_plain = cuda_ms(lambda: patches.extract_patches_plain(canvas, centers))
    print(f"[7/7] localization frame ms (frames 2-{N_FRAMES - 1}): median {_frame_ms(records):.3f}, "
          f"all {[round(r['ms'], 3) for r in records[2:]]} | mapping frame ms (frames ≥ 2): "
          f"keyframe median {_frame_ms(map_records, True):.3f}, other median "
          f"{_frame_ms(map_records, False):.3f} | keyframe-program spans "
          f"{json.dumps(summary['program_span_ms'])} | peak device memory "
          f"{summary['peak_mem_mib']:.1f} MiB | fast_nms (8 levels) {k1_ms:.4f} ms vs plain "
          f"{k1_plain:.4f} ms | patches {k2_ms:.4f} ms vs plain {k2_plain:.4f} ms", flush=True)

    kernels = [
        {"name": "fast_nms", "route": "cuda", "source": "orb_slam2_ros2_tpu_torch/csrc/fast_nms.cu",
         "replaces": "orb_slam2_ros2_tpu/ops/pallas_fast.py:109",
         "launches": launches["fast_nms"] + map_launches["fast_nms"],
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "patches", "route": "cuda", "source": "orb_slam2_ros2_tpu_torch/csrc/patches.cu",
         "replaces": "orb_slam2_ros2_tpu/ops/pallas_patches.py:116",
         "launches": launches["patches"] + map_launches["patches"],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain},
    ]
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
