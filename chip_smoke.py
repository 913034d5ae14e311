#!/usr/bin/env python3
"""Drive the PyTorch port's SLAM paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Tracking on the card replays the frame program as a captured CUDA graph
(``pipeline/frame_graph.py``): every phase below runs through it.  "Each
kernel launches once a frame" below is checked call by call: the kernel
wrappers count the launches they make (a frame run eagerly, the first frame
of a graph, the frontend of an initializing or relocalizing frame) and none
for a replay, and in every run that replays, one replay is traced by the
profiler (call 5; call 10 of a phase-12 CLI run, after the loop programs'
warm-up), where the device must run each kernel once per replay.  Frame
ms is the host's time until ``track`` returns (no synchronise after a call,
so a pipelined call returns while its frame runs); the mapping and loop
runs also print their wall time from call 6 to the end of ``flush()``.

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
     the same windows;
 11. graph + pipelined: phase 5's frames through the graph and through the
     eager program in turns, poses, stats vectors, local maps and the map
     bit-equal and one capture; one more frame of each under the profiler
     (kernel launches outside the graph, the graph launch, K1 and K2 each
     once inside the replay); phase 6's world again eagerly and with
     ``tracking.pipelined`` on the graph (every frame in order in the
     trajectory, phase 6's ATE gates, ATE ≤ 1.5 × the synchronous run's +
     0.03 m, keyframes within ±3), frame ms of eager, graph and pipelined,
     captures, bytes copied into the map storage and a full copy's device
     time; phase 9's loop world pipelined (a loop closes with a frame in
     flight, every frame in order, phase 9's ATE gates, keyframes within ±3
     of phase 9's); a pipelined
     blackout (three blank frames in phase 6's world with loop closing on:
     LOST only on them, a relocalization, the last six calls tracked); the
     batched relocalization's launches and ms (profiled in phase 7) beside
     its inliers and errors;
 12. shell: a probe line (the versions of ``google.protobuf``, Pillow,
     matplotlib and PyYAML, "missing" where absent, and whether the native
     PNG decoder builds); ``python3 -m orb_slam2_ros2_tpu_torch.cli synth
     --circle --frames 60`` as a subprocess (every frame tracked, ≥ 4
     keyframes, ATE under 5% of the path, 60 rows in both trajectory
     files); a 40-frame KITTI odometry layout at 1241×376 (8-bit PNGs
     written here with zlib, the world ``synth`` renders at 0.8 m/frame)
     run through ``cli.main`` in this process, every ``track`` call checked
     as above: plain, saving ``--save-map m.pb``; ``--pipelined``, saving
     ``--save-map mtxt/``; then a fresh run on each saved map
     (``--load-map``); then ``--viewer`` (≥ 2 PNGs over 5000 bytes); call
     10 of each run profiled.  Gates of ``tests/test_cli_e2e.py``: ≥ n − 2
     frames tracked (n − 4 on a loaded map), ≥ 2 keyframes, ATE under 5% of
     the path, n rows.  Each run prints the CLI's JSON line with its
     launches, the decoder that served its images, the ms and bytes of its
     map save or load, the CUDA-event spans of its keyframe programs and
     loop stages, and its calls' ms grouped by the programs and stages each
     ran.  A part whose library the probe found missing prints
     ``"ran": false`` and why, and is not run; no ``--config`` is passed;
 13. multi-device on the one card (it has one GPU: two shards or two roles
     share it, which measures the cost of the sharding, not scaling):
     a. ``entry.dryrun_multichip(2, devices=["cuda:0", "cuda:0"])`` — the
        landmark-sharded GBA at C=256, P=25,000, O=4 and the edge-sharded
        essential-graph PCG at K=512, each within the CPU tests'
        tolerances of its one-shard solve (cameras 1e-4 m / 1e-3°, points
        1 mm + 2e-4, gates within 2, pose graph 2e-3), their ms as CUDA
        events with the peak device memory, and the split tracking 12
        frames at 320×192;
     b. phase 9's loop world with ``dist.n_devices=2`` over those two
        slots: phase 9's gates, sharded essential-graph steps and sharded
        GBA chunks counted, keyframes within ±3 of phase 9's, the
        ``optimize_essential`` and ``gba_chunk`` spans beside phase 9's;
     c. the tracker/mapper split over phase 6's world: phase 6's gates,
        every frame ``OK``, each kernel once a frame (the tracker program
        replayed as a graph on the tracker device, call 5 traced), the
        largest pose difference from phase 6's graph run within 5e-4,
        frame ms and the keyframe-program and ``bookkeep`` spans;
     d. two processes on ``cuda:0`` joined over gloo through the
        ``SLAM_*`` variables (``entry.run_ranks``), one shard each of part
        a's problems: each rank's result against the one-process 2-shard
        mesh's (bit-equality printed; the CPU tests' tolerances gated).

 14. long runs (the default ``SLAMConfig()``): (a) the adversarial multi-lap
     world of ``validation.py`` (``AdversarialStereoDataset``: depthless
     sky, moving distractors, exposure flicker, a repeated-texture wall;
     400 frames, 150 a lap) through ``validation.run_sequence``: every frame
     posed, live ATE under 5% and final ATE under 3% of the path, at least
     one closure and every closure true (its revisit within 3 m; one made
     in the final ``flush()`` has no frame to check and is counted apart), then
     ``validation.reloc_success`` (12 kidnappings, seed 3) right at least 6
     times; printed: loop precision and recall, the post-closure laps
     localized, keyframes, the closures' frames, the frame-level loop
     queries dispatched (counted by wrapping the SLAM's method; why none,
     if none), weak-frame recoveries, frame ms (median, p90) and the spike
     ratio, the ``correct`` / ``optimize_essential`` / ``gba_chunk`` spans
     and peak device memory; (b) the same frames with
     ``tracking.pipelined``: every frame in order in the trajectory and
     (a)'s ATE and closure gates, keyframes and wall time beside (a)'s;
     (c) ``scale_run``'s configuration (a keyframe every ~3rd frame, stores
     starting at 160 keyframes and 32,768 points) on 720 frames of its
     world at 360 a lap, on a 15 m circle that stays in the world's box (the
     reference's 30 m circle leaves it): the keyframe store doubled past 256
     slots, every frame tracked, a closure on the second lap, a frame graph
     re-captured on the first frame program after each capacity change and
     at no other time, and the first replay after each re-capture bit-equal
     to the eager program on the same inputs (outputs and map); printed:
     the grow events with the ms of the grow, re-capture and first-replay
     calls, the fps curve, map MB and peak device memory.

Before the last line come the run's total seconds, a JSON object with one
entry per kernel and the card line; the last line is ``{"ok": true, "device": {...}}``.  A kernel's
``launches``, summed over the main-path runs of every phase, is its
wrapper's count (``launches_by_wrapper``) plus one a graph replay
(``launches_in_graph_replays``); ``graph_replays_profiled`` counts the
replays the profiler saw.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import warnings
import zlib

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
PROFILED_CALL = 5        # the call of each run traced by the profiler (a replay)
# shell phase: the CLI at the default SLAMConfig(); the KITTI layout is the
# world ``synth`` renders (the default box) at 0.8 m/frame
SHELL_SYNTH_FRAMES = 60
SHELL_FRAMES = 40
SHELL_SPEED = 0.8
SHELL_MAX_ATE = 0.05     # fraction of path length (tests/test_cli_e2e.py:150)
SHELL_LOST_SYNTH = 0     # frames the synth run may lose
SHELL_LOST = 2           # ... a kitti run (tests/test_cli_e2e.py:146)
SHELL_LOST_LOADED = 4    # ... a run on a loaded map (tests/test_cli_e2e.py:211)
SHELL_PROFILED_CALL = 10  # the traced call of each CLI run: a replay after the
#                          loop programs' warm-up (call 5 or 6 of a mapping run)
# multi-device phase: two mesh slots, or the tracker's and the map's device,
# on the one card
MULTI_DEVICES = ["cuda:0", "cuda:0"]
SPLIT_POSE_ATOL = 5e-4   # tests/test_split_mode.py:73
RANKS_TIMEOUT_S = 300.0
ESSENTIAL_ITERS = 20     # GN steps of the essential graph (LoopCloser.correct)
# long-run phase: the adversarial multi-lap world of validation.py (400
# frames, 150 a lap) and the scale run of scale_run.py on a circle inside
# its box
ADV_FRAMES = 400
ADV_LAP = 150
KIDNAP_ATTEMPTS = 12
KIDNAP_SEED = 3
MIN_KIDNAP_OK = 6        # tests/test_adversarial.py:132: at least half
MAX_CLOSURE_REVISIT_M = 3.0
SCALE_FRAMES = 720
SCALE_LAP = 360
SCALE_RADIUS = 15.0      # the reference's 30 m leaves the box (scale_run.scale_dataset)


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


# frame-graph replays of the current run, and replays seen by the profiler
# (the kernels inside a replay are launched by the CUDA graph, not by a wrapper)
_replays = {"run": 0, "profiled": 0}


def _reset_launches() -> None:
    fast.fast_nms_launches = 0
    patches.patch_launches = 0
    _replays["run"] = 0


def _launches() -> dict:
    """The wrappers' launch counts (eager launches) and the frame-graph
    replays of the current run."""
    return {"fast_nms": fast.fast_nms_launches, "patches": patches.patch_launches,
            "replays": _replays["run"]}


def _graphs(slam: SLAM):
    """The SLAM's frame graphs: the fused frame program's, or with the
    tracker/mapper split the tracker program's; None on the eager path."""
    return slam._frame_graphs if slam._frame_graphs is not None else slam._track_graphs


def _graph_counts(slam: SLAM) -> tuple:
    """(replays, captures) of the SLAM's frame graphs; (0, 0) on the eager path."""
    g = _graphs(slam)
    return (0, 0) if g is None else (g.replays, g.captures)


def _track(slam: SLAM, label, img_a, img_b, profile: bool = False, track=None):
    """One ``track`` call: (pose, stats, ms), ms the host's time until the
    call returned (no synchronise after it: a pipelined call returns while
    its frame runs, and a run's wall time ends with one).  Checks
    that each kernel's wrapper launched once a frame program run eagerly —
    the first frame of a graph (its capture launches nothing), every frame
    of the eager path, the frontend of a frame without a frame program
    (initialization, relocalization) — and none for a replay.  With
    ``profile`` the call runs under the profiler, must replay a frame
    graph, and the device must run each kernel once per replay on top of
    the wrappers' launches (the ms is then the traced wall time).  ``track``
    replaces ``slam.track`` (phase 12 checks the CLI's own calls)."""
    track = track or slam.track
    before, (r0, c0) = _launches(), _graph_counts(slam)
    t0 = time.perf_counter()
    if profile:
        prof = kernel_profile(lambda: track(img_a, img_b))
        pose, stats = prof.pop("result")
    else:
        pose, stats = track(img_a, img_b)
    ms = (time.perf_counter() - t0) * 1000.0
    r1, c1 = _graph_counts(slam)
    replays, captures = r1 - r0, c1 - c0
    want = captures if (captures or replays) else 1
    k1, k2 = (_launches()[k] - before[k] for k in ("fast_nms", "patches"))
    if k1 != want or k2 != want:
        raise AssertionError(f"frame {label}: kernel launches fast_nms {k1}, patches {k2}; "
                             f"this call ran {want} frame program(s) eagerly, {replays} replay(s)")
    _replays["run"] += replays
    if profile:
        seen = _kernel_counts(prof)
        if replays < 1 or seen != {"fast_nms": k1 + replays, "patches": k2 + replays}:
            raise AssertionError(f"frame {label} profiled: {replays} replay(s), {k1} eager launches, "
                                 f"the device ran {seen}")
        _replays["profiled"] += replays
    return pose, stats, ms


def _captures(slam: SLAM) -> int:
    """The SLAM's frame-graph captures, after checking that no graph was
    captured twice: the phases keep their map's capacities, so a graph is
    captured at the first use of its threshold and image shapes only."""
    log = _graphs(slam).capture_log
    if len(set(log)) != len(log):
        raise AssertionError(f"a frame graph was captured again without a capacity change: {log}")
    return len(log)


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
        pose, stats, ms = _track(slam, i, img_l, img_r, profile=i == PROFILED_CALL)
        if slam.state != TrackState.OK or pose is None:
            raise AssertionError(f"frame {i}: state {slam.state}, stats {stats}")
        err = _trans_err(pose, Twc_gt)
        rec = dict(frame=i, ms=ms, profiled=i == PROFILED_CALL, trans_err_m=err, n_inliers=stats.get("n_inliers"),
                   n_tracked=stats.get("n_tracked"), n_mappoints=stats.get("n_mappoints"))
        print(f"[5/14] frame {i}: {json.dumps(rec)}", flush=True)
        if err > MAX_TRANS_ERR_M:
            raise AssertionError(f"frame {i}: translation error {err:.4f} m > {MAX_TRANS_ERR_M}")
        records.append(rec)
    launches = _launches()
    slam.frame_sync_debug_mode = None
    med = statistics.median(r["n_inliers"] for r in records[1:])
    if med < MIN_MEDIAN_INLIERS:
        raise AssertionError(f"median n_inliers {med} < {MIN_MEDIAN_INLIERS}")
    if _captures(slam) != 1:
        raise AssertionError(f"localization: {_captures(slam)} captures")
    return records, launches, med


def run_mapping(cfg: SLAMConfig, mode: str = "graph", tag: str = "6/14", devices=None):
    """Full SLAM (keyframes, mapping, local BA; no loop closing) over the
    KITTI-like synthetic sequence; ``mode`` "graph" (the default path on the
    card: the frame program replayed as a CUDA graph), "eager" (the frame
    program launched op by op), "pipelined" (``tracking.pipelined`` on
    the graph) or "split" (``cfg`` holds the tracker/mapper split over
    ``devices``: the tracker program replayed as a graph, the bookkeeping on
    the map's device).  Returns (per-frame records, launch counts of the
    main-path run, summary, the SLAM, the frames)."""
    ds = SyntheticStereoDataset(cfg.camera, n_frames=MAP_FRAMES + 2, speed=MAP_SPEED,
                                box_scale=2.5, sky=True, device="cuda")
    frames = [ds.frame(i) for i in range(MAP_FRAMES)]  # rendered on the card, set-up
    gt_twc = {i: g for i, (_, _, g) in enumerate(frames)}
    if mode == "pipelined":
        cfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking, pipelined=True))
    slam = SLAM(cfg, enable_loop_closing=False, device="cuda", devices=devices)
    if mode == "eager":
        slam._frame_graphs = None
    slam.time_programs = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _reset_launches()
    local_ba.local_ba_runs = 0
    records = []
    for i, (img_l, img_r, _) in enumerate(frames):
        if i == PROFILED_CALL + 1:
            t_window = time.perf_counter()
        n_kf_before = slam._n_kf
        slam.frame_sync_debug_mode = "error" if i >= 2 else None
        profiled = mode != "eager" and i == PROFILED_CALL
        pose, stats, ms = _track(slam, i, img_l, img_r, profile=profiled)
        fill = mode == "pipelined" and stats.get("pipeline_fill")
        if slam.state != TrackState.OK or (pose is None and not fill):
            raise AssertionError(f"frame {i}: state {slam.state}, stats {stats}")
        rec = dict(frame=i, ms=ms, profiled=profiled, keyframe=slam._n_kf > n_kf_before,
                   n_inliers=stats.get("n_inliers"), n_tracked=stats.get("n_tracked"),
                   n_kf=slam._n_kf, next_mp=stats.get("next_mp"))
        print(f"[{tag}] {mode} frame {i}: {json.dumps(rec)}", flush=True)
        records.append(rec)
    slam.flush()
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t_window
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
    if [f for f, _ in slam.trajectory] != list(range(MAP_FRAMES)):
        raise AssertionError(f"{mode}: trajectory holds frames {[f for f, _ in slam.trajectory]}")
    ate_live, ate_final = ate(slam.trajectory), ate(slam.final_trajectory())
    spans = {}
    for name, start, end in slam.program_events:
        spans.setdefault(name, []).append(start.elapsed_time(end))
    summary = dict(
        mode=mode, wall_s_from_call_6=window_s,
        frame_graph_captures=_captures(slam) if _graphs(slam) else 0,
        capture_log=_graphs(slam).capture_log if _graphs(slam) else [],
        map_copy_bytes=slam.map_copy_bytes,
        new_keyframes=new_kfs, local_ba_runs=local_ba.local_ba_runs,
        n_keyframes=slam.n_keyframes, n_mappoints=slam.n_mappoints,
        ate_live_m=ate_live, ate_final_m=ate_final, path_len_m=path_len,
        peak_mem_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
        program_span_ms={k: dict(n=len(v), median=statistics.median(v), max=max(v))
                         for k, v in spans.items()},
    )
    print(f"[{tag}] {mode} mapping: {json.dumps(summary, default=str)}", flush=True)
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
        pose, stats, ms = _track(slam, f"{kind} {i}", img_l, img_r, profile=n == PROFILED_CALL)
        rec = dict(kind=kind, frame=i, ms=ms, profiled=n == PROFILED_CALL, state=slam.state.name,
                   n_inliers=stats.get("n_inliers"), reloc_kf=stats.get("reloc_kf"),
                   reloc_candidates=stats.get("reloc_candidates"),
                   trans_err_m=None if pose is None else _trans_err(pose, Twc_gt))
        print(f"[7/14] {json.dumps(rec)}", flush=True)
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
    # one more relocalizing frame under the profiler: the batched cascade's
    # launches and kernel time
    slam.state = TrackState.LOST
    img_l, img_r, Twc_gt = frames[RELOC_FRAME]
    prof = kernel_profile(lambda: slam.track(img_l, img_r))
    del prof["result"]
    if slam.state != TrackState.OK:
        raise AssertionError("the profiled relocalization failed")
    if slam.n_keyframes != map_slam.n_keyframes:
        raise AssertionError("localization mode inserted a keyframe")
    summary = dict(save_ms=save_ms, load_ms=load_ms, rebuild_ms=rebuild_ms, map_files_mib=file_mib,
                   frame_graph_captures=_captures(slam), capture_log=slam._frame_graphs.capture_log,
                   n_keyframes=slam.n_keyframes, kf_capacity=slam.map.kf_capacity,
                   n_words=vocab.n_words,
                   reloc_ms=[r["ms"] for r in records if r["kind"] == "reloc"],
                   lost_ms=[r["ms"] for r in records if r["kind"] == "blank"],
                   track_ms_median=statistics.median(r["ms"] for r in records
                                                     if r["kind"] == "track" and not r["profiled"]),
                   reloc_profile=prof)
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
        pose, stats, ms = _track(slam, i, rgb, depth, profile=i == PROFILED_CALL)
        if slam.state != TrackState.OK or pose is None:
            raise AssertionError(f"frame {i}: state {slam.state}, stats {stats}")
        rec = dict(frame=i, ms=ms, profiled=i == PROFILED_CALL, keyframe=slam._n_kf > n_kf_before,
                   n_inliers=stats.get("n_inliers"),
                   n_kf=slam._n_kf, n_mappoints=stats.get("n_mappoints"),
                   trans_err_m=_trans_err(pose, Twc_gt))
        print(f"[8/14] frame {i}: {json.dumps(rec)}", flush=True)
        records.append(rec)
    slam.flush()
    torch.cuda.synchronize()
    slam.frame_sync_debug_mode = None
    launches = _launches()
    gt = [f[2] for f in frames]
    ate = ate_rmse([np.linalg.inv(T.astype(np.float64)) for _, T in slam.trajectory], gt)
    path_len = float(sum(np.linalg.norm(gt[i + 1][:3, 3] - gt[i][:3, 3]) for i in range(RGBD_FRAMES - 1)))
    summary = dict(ate_m=ate, path_len_m=path_len, n_keyframes=slam.n_keyframes,
                   frame_graph_captures=_captures(slam),
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


def run_loop(cfg: SLAMConfig, tag: str = "9/14", devices=None):
    """Full SLAM with loop closing around the circle world: the first lap,
    then the second lap (bench_loop.py's index rule) until the background
    GBA has committed, at most LOOP_EXTRA frames, then ``flush()``.  The
    detection dispatches and GBA chunks run under sync debug "error"; the
    stages that may read back run under "warn", and a frame's reads are its
    warnings plus its waits for a gate or detection copy (the debug mode
    does not see event waits).  With ``tracking.pipelined`` a call returns
    the previous frame's pose (the fill marker on the first) and every frame
    must reach the trajectory in order.  Returns (records, launch counts,
    summary)."""
    pipelined = cfg.tracking.pipelined
    ds = SyntheticStereoDataset(cfg.camera, n_frames=LOOP_FRAMES, circle=True, box_scale=2.5,
                                device="cuda")
    frames = [ds.frame(i) for i in range(LOOP_FRAMES)]  # rendered on the card, set-up
    slam = SLAM(cfg, device="cuda", devices=devices)
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
        if i == PROFILED_CALL + 1:
            t_window = time.perf_counter()
        n_events, loops = len(slam.program_events), slam.loops_closed
        waits = slam.loop_closer.host_reads if slam.loop_closer is not None else 0
        slam.frame_sync_debug_mode = "error" if i >= 2 else None
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            pose, stats, ms = _track(slam, i, img_l, img_r, profile=i == PROFILED_CALL)
        if slam.state != TrackState.OK or (pose is None and not (pipelined and stats.get("pipeline_fill"))):
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
        print(f"[{tag}] frame {i}: {json.dumps(rec)}", flush=True)
        records.append(rec)
        gt.append(Twc_gt)
        i += 1
    slam.flush()
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t_window
    slam.frame_sync_debug_mode = None
    launches = _launches()

    loop_edges = slam.map.loop_edges.cpu().numpy()
    edges = loop_edges[loop_edges[:, 0] >= 0].tolist()
    if slam.loops_closed < 1 or not edges:
        raise AssertionError(f"no loop closed: loops_closed {slam.loops_closed}, loop edges {edges}, "
                             f"gates {slam.loop_closer.gate_log if slam.loop_closer else None}")
    if slam._pending_gba is not None:
        raise AssertionError("the background GBA is still pending after flush()")
    if [f for f, _ in slam.trajectory] != list(range(len(records))):
        raise AssertionError(f"the trajectory holds frames {[f for f, _ in slam.trajectory]}")

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
        frame_graph_captures=_captures(slam),
        commit_frame=commit_frame, loop_edges=edges, loops_closed=slam.loops_closed,
        gates=[g for g in slam.loop_closer.gate_log],
        n_keyframes=slam.n_keyframes, n_mappoints=slam.n_mappoints,
        ate_live_m=ate_live, ate_final_m=ate_final, path_len_m=path_len,
        median_frame_ms=med, wall_s_from_call_6=window_s,
        max_after_closure_ms=max(after) if after else None,
        spike_ratio=max(after) / med if after else None,
        reads_closure=closure_reads, reads_by_frame={r["frame"]: r["reads"] for r in records if r["reads"]},
        peak_mem_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
        span_ms={k: [round(x, 3) for x in v] for k, v in spans.items()
                 if k not in ("map_front", "map_tail", "cull_kfs", "loop_detect")},
        keyframe_span_ms={k: dict(n=len(spans[k]), median=statistics.median(spans[k]), max=max(spans[k]))
                          for k in ("map_front", "map_tail", "cull_kfs", "loop_detect") if k in spans},
    )
    print(f"[{tag}] loop{' pipelined' if pipelined else ''}: {json.dumps(summary)}", flush=True)
    if not ate_live < MAX_ATE_LIVE * path_len:
        raise AssertionError(f"loop live ATE {ate_live:.4f} m ≥ {MAX_ATE_LIVE} × {path_len:.2f} m")
    if not ate_final < MAX_ATE_FINAL * path_len:
        raise AssertionError(f"loop final ATE {ate_final:.4f} m ≥ {MAX_ATE_FINAL} × {path_len:.2f} m")
    if not ate_final <= ate_live:
        raise AssertionError(f"loop final ATE {ate_final:.4f} m worse than live {ate_live:.4f} m")
    return records, launches, summary


def kernel_profile(fn) -> dict:
    """Run ``fn`` once under ``torch.profiler``: the host's kernel launches
    (`cudaLaunchKernel`, `cuLaunchKernel`), graph launches and copies, the K1 / K2 kernels
    the device ran with their counts, the device's kernel time, the wall ms
    (inflated by the tracing) and ``fn``'s result."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1000.0
    api, kernels, dev_us, dev_kernels = {}, {}, 0.0, 0
    for e in prof.key_averages():
        if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cudaMemcpy",
                             "cudaMemset")):
            api[e.key] = api.get(e.key, 0) + e.count
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            dev_us += getattr(e, "self_device_time_total", 0.0)
            if not e.key.lower().startswith(("memcpy", "memset")):
                dev_kernels += e.count
            if "fast_nms_kernel" in e.key or "patches_kernel" in e.key:
                kernels[e.key] = e.count
    launches = sum(n for k, n in api.items() if "LaunchKernel" in k)
    return dict(launches=launches, graph_launches=sum(n for k, n in api.items() if "GraphLaunch" in k),
                device_kernels=dev_kernels, api=api, kernels=kernels, kernel_ms=dev_us / 1000.0,
                wall_ms=wall, result=result)


def _kernel_counts(prof: dict) -> dict:
    """K1 and K2 runs the device made in a profile, by kernel."""
    return {name: sum(n for k, n in prof["kernels"].items() if f"{name}_kernel" in k)
            for name in ("fast_nms", "patches")}


def _frame_outputs(slam: SLAM) -> list:
    """Keep the stats vector and the local map's ids of every frame program
    the SLAM runs."""
    seen = []
    run_frame = slam._run_frame

    def spy(*args):
        out = run_frame(*args)
        seen.append((out[2], out[3].mp_ids))
        return out

    slam._run_frame = spy
    return seen


def run_graph_vs_eager(cfg: SLAMConfig):
    """The localization frames of phase 5 through the captured frame graph
    and through the eager program, frame by frame in turns in this one
    call: poses, stats, every stats vector, the local maps' ids and the
    final map bit-equal; one capture; then one more frame of each under the
    profiler.  Returns (launch counts, summary)."""
    ds = SyntheticStereoDataset(cfg.camera, n_frames=N_FRAMES + 2, speed=SPEED, device="cuda")
    frames = [ds.frame(i) for i in range(N_FRAMES + 2)]  # rendered on the card, set-up
    slams = {"eager": SLAM(cfg, device="cuda"), "graph": SLAM(cfg, device="cuda")}
    slams["eager"]._frame_graphs = None
    seen = {k: _frame_outputs(s) for k, s in slams.items()}
    ms = {k: [] for k in slams}
    torch.cuda.synchronize()
    _reset_launches()
    for i, (img_l, img_r, _) in enumerate(frames[:N_FRAMES]):
        out = {}
        for k in (("eager", "graph") if i % 2 == 0 else ("graph", "eager")):
            slams[k].frame_sync_debug_mode = "error" if i >= 2 else None
            pose, stats, t = _track(slams[k], f"{k} {i}", img_l, img_r)
            if slams[k].state != TrackState.OK or pose is None:
                raise AssertionError(f"{k} frame {i}: state {slams[k].state}, stats {stats}")
            out[k] = (pose, stats)
            ms[k].append(t)
        if not np.array_equal(out["eager"][0], out["graph"][0]) or out["eager"][1] != out["graph"][1]:
            raise AssertionError(f"frame {i}: graph {out['graph']} differs from eager {out['eager']}")
    launches = _launches()
    if len(seen["eager"]) != len(seen["graph"]) or not all(
            torch.equal(a, b) and torch.equal(c, d) for (a, c), (b, d) in zip(seen["eager"], seen["graph"])):
        raise AssertionError("a stats vector or a local map differs between graph and eager")
    for name, a, b in zip(slams["eager"].map._fields, slams["eager"].map, slams["graph"].map):
        if not torch.equal(a, b):
            raise AssertionError(f"map field {name} differs between graph and eager")
    graphs = slams["graph"]._frame_graphs
    if graphs.captures != 1:
        raise AssertionError(f"{graphs.captures} captures over one threshold and one map")
    prof = {}
    for k, s in slams.items():
        s.frame_sync_debug_mode = None
        prof[k] = kernel_profile(lambda: s.track(*frames[N_FRAMES][:2]))
        del prof[k]["result"]
        _, _, prof[k]["untraced_ms"] = _track(s, f"{k} {N_FRAMES + 1}", *frames[N_FRAMES + 1][:2])
    g = prof["graph"]
    k_counts = sorted(g["kernels"].values())
    if g["graph_launches"] != 1 or len(g["kernels"]) != 2 or k_counts != [1, 1]:
        raise AssertionError(f"a replayed frame: {g['graph_launches']} graph launches, kernels {g['kernels']}")
    summary = dict(frames=N_FRAMES, captures=graphs.captures, capture_log=graphs.capture_log,
                   eager_ms_median=statistics.median(ms["eager"][2:]),
                   graph_ms_median=statistics.median(ms["graph"][2:]),
                   eager_ms=[round(x, 3) for x in ms["eager"]], graph_ms=[round(x, 3) for x in ms["graph"]],
                   profile=prof)
    return launches, summary


def run_pipelined_vs_sync(cfg: SLAMConfig, sync: dict, sync_records):
    """Phase 6's 40 mapping frames again, eagerly and pipelined on the graph,
    in this call: the pipelined run's trajectory holds every frame in order,
    its ATE passes phase 6's gates and stays within 1.5 × the synchronous
    run's + 0.03 m, its keyframes within ±3 of it.  Returns (launch counts
    of both runs, summary, the pipelined SLAM)."""
    eager_records, eager_launches, eager, _, _ = run_mapping(cfg, "eager", "11/14")
    pipe_records, pipe_launches, pipe, pipe_slam, _ = run_mapping(cfg, "pipelined", "11/14")
    if not pipe["ate_live_m"] <= 1.5 * sync["ate_live_m"] + 0.03:
        raise AssertionError(f"pipelined live ATE {pipe['ate_live_m']:.4f} m > 1.5 × sync "
                             f"{sync['ate_live_m']:.4f} m + 0.03")
    if abs(pipe["n_keyframes"] - sync["n_keyframes"]) > 3:
        raise AssertionError(f"pipelined {pipe['n_keyframes']} keyframes, sync {sync['n_keyframes']}")

    def medians(records, run):
        return dict(keyframe=_frame_ms(records, True), other=_frame_ms(records, False),
                    all=_frame_ms(records), wall_s_from_call_6=run["wall_s_from_call_6"])

    store = list(pipe_slam.map)
    src = [t.clone() for t in store]
    copy_ms = device_ms(lambda: torch._foreach_copy_(store, src), runs=20)
    summary = dict(
        frame_ms=dict(eager=medians(eager_records, eager), graph=medians(sync_records, sync),
                      pipelined=medians(pipe_records, pipe)),
        ate_m=dict(eager=(eager["ate_live_m"], eager["ate_final_m"]),
                   graph=(sync["ate_live_m"], sync["ate_final_m"]),
                   pipelined=(pipe["ate_live_m"], pipe["ate_final_m"])),
        keyframes=dict(eager=eager["n_keyframes"], graph=sync["n_keyframes"], pipelined=pipe["n_keyframes"]),
        captures=dict(graph=sync["frame_graph_captures"], pipelined=pipe["frame_graph_captures"]),
        map_copy_bytes=dict(graph=sync["map_copy_bytes"], pipelined=pipe["map_copy_bytes"]),
        full_map_bytes=sum(t.numel() * t.element_size() for t in store), full_map_copy_ms=copy_ms,
    )
    return (eager_launches, pipe_launches), summary


def run_pipelined_blackout(cfg: SLAMConfig):
    """Pipelined full SLAM with loop closing (its keyframe database is what
    relocalization queries) over phase 6's world: frames 0-23, three blank
    frames, then frames 14-23 again.  The loss is found one frame late, the
    speculative frame abandoned, the next real frame relocalizes and the
    rest track on.  Returns (launch counts, summary)."""
    cfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking, pipelined=True))
    ds = SyntheticStereoDataset(cfg.camera, n_frames=MAP_FRAMES + 2, speed=MAP_SPEED,
                                box_scale=2.5, sky=True, device="cuda")
    frames = [ds.frame(i) for i in range(24)]  # rendered on the card, set-up
    blank = torch.zeros_like(frames[0][0])
    plan = list(range(24)) + [None] * 3 + list(range(14, 24))
    slam = SLAM(cfg, device="cuda")
    torch.cuda.synchronize()
    _reset_launches()
    calls = []
    for n, k in enumerate(plan):
        img_l, img_r = (blank, blank) if k is None else frames[k][:2]
        pose, stats, ms = _track(slam, f"blackout {n}", img_l, img_r, profile=n == PROFILED_CALL)
        calls.append(dict(call=n, src=k, state=slam.state.name, pose=pose is not None,
                          relocalized=bool(stats.get("relocalized")), n_inliers=stats.get("n_inliers"), ms=ms))
    slam.flush()
    torch.cuda.synchronize()
    launches = _launches()
    states = [c["state"] for c in calls]
    lost = [c["call"] for c in calls if c["state"] == "LOST"]
    reloc = [c["call"] for c in calls if c["relocalized"]]
    if not lost or not all(plan[n] is None for n in lost):
        raise AssertionError(f"blackout: LOST at calls {lost}, states {states}")
    if not reloc or not all(c["state"] == "OK" and c["pose"] for c in calls[-6:]):
        raise AssertionError(f"blackout: relocalized at {reloc}, last calls {calls[-6:]}")
    fids = [f for f, _ in slam.trajectory]
    if fids != sorted(fids) or fids[-6:] != list(range(len(plan) - 6, len(plan))):
        raise AssertionError(f"blackout: trajectory {fids}")
    summary = dict(lost_calls=lost, relocalized_calls=reloc, n_keyframes=slam.n_keyframes,
                   captures=_captures(slam), trajectory_frames=len(fids),
                   reloc_ms=[round(c["ms"], 1) for c in calls if c["relocalized"]],
                   tracked_ms_after=statistics.median(c["ms"] for c in calls[-6:]))
    return launches, summary


# ------------------------------------------------------------------ shell --

def probe_shell() -> dict:
    """Versions of the shell's optional libraries ("missing" where absent)
    and whether the native PNG decoder builds here."""
    import importlib

    from orb_slam2_ros2_tpu_torch.io import native_loader

    out = {}
    for mod in ("google.protobuf", "PIL", "matplotlib", "yaml"):
        try:
            out[mod] = getattr(importlib.import_module(mod), "__version__", "present")
        except ImportError:
            out[mod] = "missing"
    out["native_decoder"] = "built" if native_loader.get_lib() is not None else native_loader.build_error
    return out


def write_png_gray8(path: str, img: np.ndarray) -> None:
    """An 8-bit greyscale PNG (filter 0 on every row), written with zlib."""
    h, w = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def path_length(poses_wc) -> float:
    t = np.stack([np.asarray(T)[:3, 3] for T in poses_wc])
    return float(np.linalg.norm(np.diff(t, axis=0), axis=1).sum())


def write_kitti_layout(root: str, cfg: SLAMConfig, n: int, speed: float) -> float:
    """A KITTI odometry sequence on disk (image_0/ image_1/ times.txt
    poses.txt) of the world ``synth`` renders; returns its path length."""
    from orb_slam2_ros2_tpu_torch.io.trajectory import write_kitti

    for d in ("image_0", "image_1"):
        os.makedirs(os.path.join(root, d))
    ds = SyntheticStereoDataset(cfg.camera, n_frames=n, speed=speed, device="cuda")
    poses = []
    for i in range(n):
        img_l, img_r, Twc = ds.frame(i)
        for d, img in (("image_0", img_l), ("image_1", img_r)):
            write_png_gray8(os.path.join(root, d, f"{i:06d}.png"),
                            img.clamp(0, 255).to(torch.uint8).cpu().numpy())
        poses.append(Twc)
    with open(os.path.join(root, "times.txt"), "w") as f:
        f.write("".join(f"{0.1 * i:.6f}\n" for i in range(n)))
    write_kitti(os.path.join(root, "poses.txt"), poses)
    return path_length(poses)


def run_cli(argv) -> dict:
    """``cli.main(argv)`` in this process, every ``SLAM.track`` it makes
    checked by ``_track`` (each kernel once a frame program; call
    SHELL_PROFILED_CALL traced, K1 and K2 once inside its replay) and its
    ``save`` / ``load`` timed.  Returns the CLI's JSON line with the run's
    launch counts, ms of save / load, the decoders that served its images,
    the SLAM's frame-graph captures, the CUDA-event spans of its keyframe
    programs and loop stages, and the calls' host ms grouped by the
    programs and stages each call ran (calls ≥ 2, the traced one left
    out)."""
    import contextlib
    import io

    from orb_slam2_ros2_tpu_torch import cli
    from orb_slam2_ros2_tpu_torch.io import datasets

    orig = {name: getattr(SLAM, name) for name in ("track", "save", "load")}
    rec = dict(calls=0, save_ms=None, load_ms=None, slam=None, ms=[], stages=[])

    def track(self, img_a, img_b):
        i = rec["calls"]
        rec["calls"] += 1
        rec["slam"] = self
        self.time_programs = True
        n_events = len(self.program_events)
        pose, stats, ms = _track(self, i, img_a, img_b, profile=i == SHELL_PROFILED_CALL,
                                 track=lambda a, b: orig["track"](self, a, b))
        rec["ms"].append(ms)
        rec["stages"].append("+".join(e[0] for e in self.program_events[n_events:]) or "none")
        return pose, stats

    def timed(name):
        def call(self, path):
            t0 = time.perf_counter()
            orig[name](self, path)
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            rec[f"{name}_ms"] = (time.perf_counter() - t0) * 1000.0
        return call

    decoded = dict(datasets.decoders)
    out = io.StringIO()
    _reset_launches()
    SLAM.track, SLAM.save, SLAM.load = track, timed("save"), timed("load")
    try:
        with contextlib.redirect_stdout(out):
            cli.main(argv)
    finally:
        SLAM.track, SLAM.save, SLAM.load = orig["track"], orig["save"], orig["load"]
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    ms, slam = rec["ms"], rec["slam"]
    torch.cuda.synchronize()
    by_stages: dict = {}
    for i, (x, stages) in enumerate(zip(ms, rec["stages"])):
        if i >= 2 and i != SHELL_PROFILED_CALL:
            by_stages.setdefault(stages, []).append(x)
    slowest = int(np.argmax(ms))
    res.update(launches=_launches(), save_ms=rec["save_ms"], load_ms=rec["load_ms"],
               calls_0_4_ms=[round(x, 1) for x in ms[:5]], slowest_call=slowest,
               slowest_call_ms=max(ms), slowest_call_stages=rec["stages"][slowest],
               profiled_call=SHELL_PROFILED_CALL, profiled_call_stages=rec["stages"][SHELL_PROFILED_CALL],
               call_ms_by_stages={k: dict(n=len(v), median=statistics.median(v), max=max(v))
                                  for k, v in by_stages.items()},
               program_span_ms={k: dict(n=len(v), median=statistics.median(v), max=max(v), sum=sum(v))
                                for k, v in _span_ms(slam).items()},
               decoded={k: datasets.decoders[k] - decoded[k] for k in decoded},
               captures=_captures(slam) if slam._frame_graphs is not None else 0)
    return res


def _check_run(part: str, res: dict, n: int, lost: int, path: float, out: str, min_keyframes: int = 1) -> None:
    """The gates of a CLI run: frames tracked, keyframes, ATE under 5% of
    the path, both trajectory files with a row a frame."""
    rows = np.loadtxt(out + ".kitti.txt")
    tum = np.loadtxt(out + ".tum.txt")
    if res["frames"] != n or res["tracked"] < n - lost:
        raise AssertionError(f"shell {part}: {res['tracked']} of {res['frames']} tracked, want ≥ {n - lost} of {n}")
    if "ate_rmse" not in res or not res["ate_rmse"] < SHELL_MAX_ATE * path:
        raise AssertionError(f"shell {part}: ATE {res.get('ate_rmse')} m ≥ {SHELL_MAX_ATE} × {path:.2f} m")
    if rows.shape != (n, 12) or tum.shape != (n, 8):
        raise AssertionError(f"shell {part}: trajectory files {rows.shape} and {tum.shape}")
    if res["keyframes"] < min_keyframes:
        raise AssertionError(f"shell {part}: {res['keyframes']} keyframes < {min_keyframes}")


def run_shell(cfg: SLAMConfig, probe: dict) -> tuple:
    """Phase 12: the port's CLI at ``cfg``, the default ``SLAMConfig()``
    (the CLI's own when no ``--config`` is given).  ``synth`` as a
    subprocess; ``kitti`` in this process on a disk layout — plain, saving
    ``.pb``; pipelined, saving txt; on each saved map; with the viewer —
    each gated, call SHELL_PROFILED_CALL of each traced.  Returns (the
    launch counts of the in-process runs, the parts' records)."""
    here = os.path.dirname(os.path.abspath(__file__))
    parts, launches = [], []
    with tempfile.TemporaryDirectory() as tmp:
        # synth through the real entry point, in its own process
        t0 = time.perf_counter()
        cmd = [sys.executable, "-m", "orb_slam2_ros2_tpu_torch.cli", "synth", "--circle",
               "--frames", str(SHELL_SYNTH_FRAMES), "--out", f"{tmp}/s", "--device", "cuda"]
        proc = subprocess.run(cmd, cwd=here, capture_output=True, text=True, timeout=600,
                              env=dict(os.environ, PYTHONPATH=here))
        if proc.returncode != 0:
            raise AssertionError(f"shell synth: rc {proc.returncode}\n{proc.stderr[-3000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        synth_path = path_length(SyntheticStereoDataset(cfg.camera, n_frames=SHELL_SYNTH_FRAMES, circle=True,
                                                        device="cpu").poses_wc)
        _check_run("synth", res, SHELL_SYNTH_FRAMES, SHELL_LOST_SYNTH, synth_path, f"{tmp}/s", min_keyframes=4)
        parts.append(dict(part="synth", ran=True, subprocess_s=time.perf_counter() - t0,
                          path_len_m=synth_path, **res))
        print(f"[12/14] synth (python -m ..., its launches are counted in its own process): "
              f"{json.dumps(parts[-1])}", flush=True)

        seq = f"{tmp}/00"
        t0 = time.perf_counter()
        path = write_kitti_layout(seq, cfg, SHELL_FRAMES, SHELL_SPEED)
        layout_s = time.perf_counter() - t0
        kitti = ["kitti", "--seq", seq, "--device", "cuda"]
        have_pb = probe["google.protobuf"] != "missing"
        pb, txt = (f"{tmp}/m.pb", f"{tmp}/mtxt/") if have_pb else (None, None)
        # (part, CLI flags, frames it may lose, map it saves)
        runs = [("kitti", ["--save-map", pb] if pb else [], SHELL_LOST, pb),
                ("pipelined", ["--pipelined"] + (["--save-map", txt] if txt else []), SHELL_LOST, txt)]
        if have_pb:
            runs += [("load .pb", ["--load-map", pb], SHELL_LOST_LOADED, None),
                     ("load txt", ["--load-map", txt], SHELL_LOST_LOADED, None)]
        else:
            parts.append(dict(part="map formats", ran=False, why="google.protobuf missing"))
            print(f"[12/14] {json.dumps(parts[-1])}", flush=True)
        if probe["matplotlib"] != "missing":
            runs.append(("viewer", ["--viewer", f"{tmp}/film", "--viewer-every", "10"], SHELL_LOST, None))
        else:
            parts.append(dict(part="viewer", ran=False, why="matplotlib missing"))
            print(f"[12/14] {json.dumps(parts[-1])}", flush=True)
        for i, (part, args, lost, saves) in enumerate(runs):
            out = f"{tmp}/k{i}"
            res = run_cli([*kitti, "--out", out, *args])
            _check_run(part, res, SHELL_FRAMES, lost, path, out, min_keyframes=2)
            if part == "kitti":
                res["layout_write_s"] = layout_s
            if part == "viewer":
                pngs = [f for f in os.listdir(f"{tmp}/film") if f.endswith(".png")]
                big = [f for f in pngs if os.path.getsize(f"{tmp}/film/{f}") > 5000]
                if len(big) < 2:
                    raise AssertionError(f"shell viewer: {len(big)} PNGs over 5000 bytes of {len(pngs)}")
                res["viewer_pngs"] = len(big)
            if saves:
                files = [saves + f for f in os.listdir(saves)] if os.path.isdir(saves) else [saves]
                res["saved_bytes"] = sum(os.path.getsize(f) for f in files)
            launches.append(res["launches"])
            parts.append(dict(part=part, ran=True, argv=args, path_len_m=path, **res))
            print(f"[12/14] {part}: {json.dumps(parts[-1])}", flush=True)
    return launches, parts


# ------------------------------------------------------------ multi-device --

class _Spy:
    """Counts, while it is active, the calls of ``obj.name`` (a module's
    function or an instance's method) that ``pred(*args, **kw)`` picks
    (every call when ``pred`` is None), and in ``true`` the calls that
    returned something true."""

    def __init__(self, obj, name, pred=None):
        self.obj, self.name, self.pred, self.calls, self.true = obj, name, pred, 0, 0
        self.orig, self.own = getattr(obj, name), name in vars(obj)

    def __enter__(self):
        def spy(*a, **kw):
            self.calls += self.pred is None or bool(self.pred(*a, **kw))
            out = self.orig(*a, **kw)
            self.true += bool(out)
            return out

        setattr(self.obj, self.name, spy)
        return self

    def __exit__(self, *exc):
        if self.own:
            setattr(self.obj, self.name, self.orig)
        else:
            delattr(self.obj, self.name)


def run_multi_device(base: SLAMConfig, map_cfg: SLAMConfig, loop: dict, map_summary: dict, map_poses: list):
    """Phase 13 on the one card: (a) the dry run's sharded GBA and essential
    graph against their one-shard solves; (b) phase 9's loop world over a
    two-shard mesh; (c) the tracker/mapper split over phase 6's mapping
    world; (d) two processes joined over gloo solving part a's problems.
    Returns (launch counts of parts b and c, summary)."""
    from orb_slam2_ros2_tpu_torch import entry
    from orb_slam2_ros2_tpu_torch.parallel import ba_mesh
    from orb_slam2_ros2_tpu_torch.solvers import global_ba as gba_mod
    from orb_slam2_ros2_tpu_torch.solvers import pose_graph as pg_mod

    out = {}
    t0 = time.perf_counter()
    dry = entry.dryrun_multichip(2, devices=MULTI_DEVICES)
    bad = {k: dry[k] for k, lim in (("gba_pose_diff_m", 1e-4), ("gba_rot_diff_deg", 1e-3),
                                    ("gba_point_excess_m", 0.0), ("gba_gate_diff", 2), ("pg_diff", 2e-3))
           if not dry[k] <= lim}
    print(f"[13/14] a. dry run, 2 shards on one card: {json.dumps(dry)} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    if bad:
        raise AssertionError(f"the sharded solves left the one-shard solves' tolerances: {bad}")
    out["a"] = dry

    t0 = time.perf_counter()
    mesh_cfg = base.replace(dist=dataclasses.replace(base.dist, n_devices=2))
    with _Spy(pg_mod, "_gn_step_pcg_sharded", lambda *a, **kw: True) as pcg,             _Spy(gba_mod, "global_ba_phase", lambda *a, axis=None, **kw: axis is not None) as chunks:
        _, loop_launches, lp = run_loop(mesh_cfg, tag="13/14", devices=MULTI_DEVICES)
    spans = {k: {"mesh": lp["span_ms"].get(k), "phase 9": loop["span_ms"].get(k)}
             for k in ("optimize_essential", "gba_chunk")}
    b = dict(sharded_pcg_steps=pcg.calls, sharded_gba_chunks=chunks.calls, closure_frame=lp["closure_frame"],
             n_keyframes=lp["n_keyframes"], phase9_keyframes=loop["n_keyframes"],
             ate_live_m=lp["ate_live_m"], ate_final_m=lp["ate_final_m"], path_len_m=lp["path_len_m"],
             median_frame_ms=lp["median_frame_ms"], phase9_median_frame_ms=loop["median_frame_ms"],
             peak_mem_mib=lp["peak_mem_mib"], spans_ms=spans, seconds=time.perf_counter() - t0)
    print(f"[13/14] b. loop world over a 2-shard mesh: {json.dumps(b)}", flush=True)
    # the loop programs' warm-up runs 20 sharded steps and 2 chunks, the
    # closure 20 steps and every chunk of the background solve
    want = (2 * ESSENTIAL_ITERS, 2 + sum(base.loop.global_ba_phase_iters))
    if pcg.calls < want[0] or chunks.calls < want[1]:
        raise AssertionError(f"the loop world ran {pcg.calls} sharded essential-graph steps and "
                             f"{chunks.calls} sharded GBA chunks, fewer than {want}")
    if abs(lp["n_keyframes"] - loop["n_keyframes"]) > 3:
        raise AssertionError(f"mesh: {lp['n_keyframes']} keyframes, phase 9 {loop['n_keyframes']}")
    out["b"] = b

    t0 = time.perf_counter()
    split_cfg = map_cfg.replace(dist=dataclasses.replace(map_cfg.dist, tracker_mapper_split=True))
    recs, split_launches, sm, slam, _ = run_mapping(split_cfg, "split", "13/14", devices=MULTI_DEVICES)
    diff = max(float(np.abs(a - b).max()) for (_, a), b in zip(slam.trajectory, map_poses))
    c = dict(pose_diff_vs_phase6=diff, within_5e4=diff <= SPLIT_POSE_ATOL,
             frame_ms_keyframe=_frame_ms(recs, True), frame_ms_other=_frame_ms(recs, False),
             wall_s_from_call_6=sm["wall_s_from_call_6"], phase6_wall_s_from_call_6=map_summary["wall_s_from_call_6"],
             phase6_frame_ms_keyframe=map_summary["frame_ms_keyframe"],
             phase6_frame_ms_other=map_summary["frame_ms_other"],
             new_keyframes=sm["new_keyframes"], phase6_new_keyframes=map_summary["new_keyframes"],
             ate_live_m=sm["ate_live_m"], ate_final_m=sm["ate_final_m"],
             spans_ms=sm["program_span_ms"], captures=sm["frame_graph_captures"],
             map_device=str(slam.map_device), tracker_device=str(slam.device),
             seconds=time.perf_counter() - t0)
    print(f"[13/14] c. tracker/mapper split on one card: {json.dumps(c)}, launches {split_launches}", flush=True)
    if len(slam.trajectory) != MAP_FRAMES:
        raise AssertionError(f"the split tracked {len(slam.trajectory)} of {MAP_FRAMES} frames")
    if not diff <= SPLIT_POSE_ATOL:
        raise AssertionError(f"the split's poses left phase 6's by {diff} > {SPLIT_POSE_ATOL}")
    out["c"] = c
    del slam

    t0 = time.perf_counter()
    C, P, K = 256, 25000, 512
    ref = entry.sharded_solves(ba_mesh(2, devices=MULTI_DEVICES), C, P, K, "cuda:0")
    with tempfile.TemporaryDirectory() as tmp:
        ranks = entry.run_ranks(2, "cuda:0", C, P, K, tmp, timeout=RANKS_TIMEOUT_S)
    d = {"seconds": time.perf_counter() - t0, "ranks": []}
    for rank, res in enumerate(ranks):
        row = {name: dict(bit_equal=bool(torch.equal(res[name], want)),
                          max_abs=float((res[name].float() - want.float()).abs().max()))
               for name, want in ref.items()}
        d["ranks"].append(row)
        bad = {k: v for k, v in row.items() if v["max_abs"] > (2 if k == "gate" else
                                                              2e-3 if k == "pg_T" else 1e-4)}
        if bad:
            raise AssertionError(f"rank {rank} left the one-process mesh's tolerances: {bad}")
    print(f"[13/14] d. two gloo ranks on one card against the one-process 2-shard mesh: {json.dumps(d)}",
          flush=True)
    out["d"] = d
    return (loop_launches, split_launches), out


# --------------------------------------------------------------- long runs --

class _Frames:
    """A dataset's first ``n`` frames rendered once (set-up), served by
    ``frame(i)``."""

    def __init__(self, ds, n: int):
        self.frames = [ds.frame(i) for i in range(n)]

    def frame(self, i: int):
        return self.frames[i]


def _tracker(slam: SLAM, tag: str, records: list):
    """``track(img_l, img_r)`` through ``_track`` (each kernel once a frame
    program, call PROFILED_CALL traced), frame programs from call 2 on under
    sync debug "error"; each call appends its record: ms, whether it
    inserted a keyframe or closed a loop (and whether a GBA was in flight
    then), the programs and stages it ran, its frame-graph replays and
    captures, its inliers and whether it fell back to the reference
    keyframe."""
    def track(img_a, img_b):
        i = len(records)
        n_events, loops, n_kf = len(slam.program_events), slam.loops_closed, slam._n_kf
        gba_pending = slam._pending_gba is not None
        (r0, c0) = _graph_counts(slam)
        slam.frame_sync_debug_mode = "error" if i >= 2 else None
        pose, stats, ms = _track(slam, f"{tag} {i}", img_a, img_b, profile=i == PROFILED_CALL)
        r1, c1 = _graph_counts(slam)
        records.append(dict(call=i, ms=ms, profiled=i == PROFILED_CALL, keyframe=slam._n_kf > n_kf,
                            closure=slam.loops_closed > loops, replays=r1 - r0, captures=c1 - c0,
                            stages=sorted({name for name, _, _ in slam.program_events[n_events:]}),
                            gba_pending=gba_pending, since_kf=slam.frames_since_kf, state=slam.state.name,
                            n_inliers=stats.get("n_inliers"), ref_fallback=bool(stats.get("ref_fallback")),
                            relocalized=bool(stats.get("relocalized"))))
        return pose, stats
    return track


def _ms_stats(records, closures=()) -> dict:
    """Median and p90 of the calls' ms from call 10 on (the traced call left
    out), and the largest call from the first closure on over that median."""
    ms = [r["ms"] for r in records[10:] if not r["profiled"]]
    med = statistics.median(ms)
    after = [r["ms"] for r in records[closures[0]:]] if closures else []
    return dict(median_ms=med, p90_ms=float(np.percentile(ms, 90)), max_ms=max(r["ms"] for r in records),
                max_after_closure_ms=max(after) if after else None,
                spike_ratio=max(after) / med if after else None)


def _after_closures(records) -> list:
    """Each closure's call, whether it found a GBA in flight (which it
    discards), and the inliers of the two calls after it (the motion model
    restarts from the identity after a synchronous correction)."""
    return [dict(call=r["call"], gba_in_flight=r["gba_pending"],
                 next_inliers=[x["n_inliers"] for x in records[r["call"] + 1:r["call"] + 3]],
                 next_fallbacks=sum(x["ref_fallback"] for x in records[r["call"] + 1:r["call"] + 3]))
            for r in records if r["closure"]]


def _closure_truth(closures, gt, lap: int) -> list:
    """(closure frame, revisit distance in m) a closure: the ground-truth
    distance to the previous lap's pose at the same lap angle (None before
    any revisit: a false closure)."""
    out = []
    for i in closures:
        j = i - lap
        out.append((i, float(np.linalg.norm(gt[i][:3, 3] - gt[j][:3, 3])) if j >= 0 else None))
    return out


def run_adversarial(cfg: SLAMConfig, frames: _Frames, n_frames: int, tag: str, kidnap: bool):
    """The adversarial multi-lap world (``validation.py``'s defaults: 400
    frames, 150 a lap) through ``validation.run_sequence``, synchronous or
    pipelined: every frame posed (in order, pipelined), live ATE under 5%
    and final ATE under 3% of the path, at least one closure during the
    frames and every such closure true (its revisit within 3 m; closures
    made in the final ``flush()`` are counted apart); with ``kidnap`` then
    ``validation.reloc_success`` (12 attempts, seed 3) at least 6 right.
    Frame-level loop queries and weak-frame recoveries are counted by
    wrapping the SLAM's methods.  Returns (launch counts, summary)."""
    from orb_slam2_ros2_tpu_torch import validation

    pipelined = cfg.tracking.pipelined
    slam = SLAM(cfg, device="cuda")
    slam.time_programs = True
    records: list = []
    track = _tracker(slam, tag, records)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    with _Spy(slam, "_dispatch_frame_loop_query") as queries, _Spy(slam, "_track_reference") as recoveries:
        est, gt, closures, lost = validation.run_sequence(slam, frames, n_frames, track=track)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    # a closure made in the final flush() has no frame whose revisit the
    # truth gate could check: it is counted apart and gates nothing
    flush_closures = slam.loops_closed - len(closures)
    fids = [f for f, _ in slam.trajectory]
    if fids != list(range(n_frames)):
        raise AssertionError(f"{tag}: the trajectory holds frames {fids[:5]}…{fids[-5:]} ({len(fids)})")
    if pipelined:
        # a call returns the previous frame's pose (the fill marker on call 1)
        est = [np.linalg.inv(T.astype(np.float64)) for _, T in slam.trajectory]
        lost = sum(1 for r in records if r["state"] != "OK")
    if lost:
        raise AssertionError(f"{tag}: {lost} frames returned no pose")
    path = float(sum(np.linalg.norm(gt[k + 1][:3, 3] - gt[k][:3, 3]) for k in range(n_frames - 1)))
    ate_live, ate_final = validation.ate_of(est, gt), validation.ate_final_of(slam, gt)
    prec, rec, n_acc, tp, n_opp, laps_hit, n_post, n_loc = validation.loop_precision_recall(
        slam, est, gt, closures, ADV_LAP, n_frames)
    spans = _span_ms(slam)
    summary = dict(
        frames=n_frames, pipelined=pipelined, wall_s=wall_s, keyframes_inserted=slam._n_kf,
        keyframes_live=slam.n_keyframes, n_mappoints=slam.n_mappoints,
        closures=_closure_truth(closures, gt, ADV_LAP), flush_closures=flush_closures,
        loops_closed=slam.loops_closed,
        after_closures=_after_closures(records[:n_frames]),
        loop_precision=prec, loop_recall=rec, closure_opportunity_laps=n_opp, laps_with_true_closure=laps_hit,
        post_closure_laps=n_post, post_closure_laps_localized=n_loc,
        ate_live_m=ate_live, ate_final_m=ate_final, path_len_m=path,
        frame_loop_queries=queries.calls, weak_frame_recoveries=recoveries.calls,
        weak_frame_recoveries_ok=recoveries.true, max_frames_since_kf=max(r["since_kf"] for r in records),
        frame_graph_captures=_captures(slam), **_ms_stats(records, closures),
        span_ms={k: [round(x, 3) for x in spans[k]] for k in ("correct", "optimize_essential", "gba_chunk",
                                                                "gba_commit") if k in spans},
        keyframe_span_ms={k: dict(n=len(v), median=statistics.median(v), max=max(v))
                          for k, v in spans.items() if k in ("map_front", "map_tail", "cull_kfs", "loop_detect")},
        peak_mem_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
    )
    if queries.calls == 0:
        t = cfg.tracking
        summary["frame_loop_queries_why_none"] = (
            f"frames since a keyframe peaked at {summary['max_frames_since_kf']} (the queries need more than "
            f"max_frames {t.max_frames}, on every {cfg.loop.frame_query_stride}-th frame, "
            f"{10 * t.max_frames} frames clear of a closure)")
    if kidnap:
        rate, n_att = validation.reloc_success(slam, frames, ADV_LAP, n_frames, est, KIDNAP_ATTEMPTS,
                                               KIDNAP_SEED, track=track)
        summary.update(kidnap_ok=round(rate * n_att), kidnap_attempts=n_att,
                       kidnap_ms=[round(r["ms"], 1) for r in records[n_frames:]])
    launches = _launches()
    print(f"[14/14] {tag}: {json.dumps(summary)}", flush=True)
    if not ate_live < MAX_ATE_LIVE * path:
        raise AssertionError(f"{tag}: live ATE {ate_live:.4f} m ≥ {MAX_ATE_LIVE} × {path:.2f} m")
    if not ate_final < MAX_ATE_FINAL * path:
        raise AssertionError(f"{tag}: final ATE {ate_final:.4f} m ≥ {MAX_ATE_FINAL} × {path:.2f} m")
    false = [c for c in summary["closures"] if c[1] is None or c[1] >= MAX_CLOSURE_REVISIT_M]
    if not closures or false:
        raise AssertionError(f"{tag}: closures {summary['closures']} (none, or false ones: {false})")
    if kidnap and summary["kidnap_ok"] < MIN_KIDNAP_OK:
        raise AssertionError(f"{tag}: kidnapping relocalized at the right place {summary['kidnap_ok']} of "
                             f"{n_att} < {MIN_KIDNAP_OK}")
    return launches, summary


def _eager_twin(slam: SLAM, img_a, img_b):
    """The frame program run eagerly on the inputs the next ``track`` call
    hands its graph, over a copy of the map (its kernel launches are taken
    back out of the wrappers' counts: they compare, they are not the main
    path's), and a spy that keeps the graph's outputs and the map right
    after that call's frame program.  Returns (eager leaves, eager map,
    what the spy saw)."""
    from orb_slam2_ros2_tpu_torch.mapstate.map_state import MapState, kf_index
    from orb_slam2_ros2_tpu_torch.pipeline.frame_graph import tree_leaves

    proj_th = 5.0 if slam.frame_id < slam.last_reloc_fid + 2 else 3.0
    counts = (fast.fast_nms_launches, patches.patch_launches)
    mapstate = MapState(*(t.clone() for t in slam.map))
    new_state, velocity, host_vec, mapstate, local = slam.frame_program(
        img_a, img_b, slam.last, slam.velocity, slam.local, mapstate, kf_index(slam.ref_kf, slam.device),
        proj_th=proj_th)
    fast.fast_nms_launches, patches.patch_launches = counts
    seen: dict = {}
    run_frame = slam._run_frame

    def spy(*args):
        out = run_frame(*args)
        if not seen:
            seen.update(leaves=tree_leaves(out), map=[t.clone() for t in slam.map])
            del slam._run_frame
        return out

    slam._run_frame = spy
    return tree_leaves((new_state, velocity, host_vec, local)), list(mapstate), seen


def run_scale(base: SLAMConfig):
    """``scale_run``'s configuration (keyframes every ~3rd frame, stores
    starting at 160 keyframes and 32,768 points, auto-grow) on SCALE_FRAMES
    frames of its world at SCALE_LAP a lap on a circle of SCALE_RADIUS
    inside the box.  Gates: the keyframe store doubled, past 256 slots (the
    PCG essential graph), every frame tracked, a closure on the second lap;
    a frame graph captured only at the first use of its threshold after a
    capacity change, and re-captured on the first frame program after each;
    the first replay after each re-capture bit-equal to the eager program
    on the same inputs (a re-capture followed by another capacity change
    before its first replay has none).  Returns (launch counts, summary)."""
    from orb_slam2_ros2_tpu_torch import scale_run

    cfg = scale_run.scale_config(base)
    ds = scale_run.scale_dataset(cfg, SCALE_FRAMES, SCALE_LAP, "cuda", SCALE_RADIUS)
    slam = SLAM(cfg, device="cuda")
    slam.time_programs = True
    graphs = slam._frame_graphs
    records: list = []
    inner = _tracker(slam, "c", records)
    st = dict(keys=set(), must_capture=False, compare=False, twin=None, compared=[], bad=[])

    def track(img_a, img_b):
        i = len(records)
        cap0 = (slam.map.kf_capacity, slam.map.mp_capacity)
        twin = (_eager_twin(slam, img_a, img_b)
                if st["compare"] and not st["must_capture"] and slam.state == TrackState.OK else None)
        pose, stats = inner(img_a, img_b)
        slam.__dict__.pop("_run_frame", None)   # the twin's spy, if no frame program ran
        rec = records[-1]
        rec["cap"] = [slam.map.kf_capacity, slam.map.mp_capacity]
        if rec["captures"]:
            key = graphs.capture_log[-1][0]
            if key in st["keys"]:
                st["bad"].append(f"call {i}: graph {key} captured again without a capacity change")
            st["keys"].add(key)
        if st["must_capture"] and (rec["replays"] or rec["captures"]):
            if not rec["captures"]:
                st["bad"].append(f"call {i}: the first frame program after a capacity change replayed")
            st["must_capture"], st["compare"] = False, True
        elif twin is not None:
            leaves, mapstate, seen = twin
            if not seen or rec["captures"]:
                st["bad"].append(f"call {i}: no replay to compare")
            else:
                diff = [k for k, (a, b) in enumerate(zip(leaves, seen["leaves"])) if not torch.equal(a, b)]
                fields = [n for n, a, b in zip(slam.map._fields, mapstate, seen["map"]) if not torch.equal(a, b)]
                st["compared"].append(dict(call=i, outputs=len(leaves), outputs_differ=diff, map_differs=fields))
                if diff or fields:
                    st["bad"].append(f"call {i}: replay differs from eager: outputs {diff}, map {fields}")
            st["compare"] = False
        if tuple(rec["cap"]) != cap0:
            st["keys"], st["must_capture"] = set(), True
        return pose, stats

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    res = scale_run.run(slam, ds, SCALE_FRAMES, track=track)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = _launches()
    for g in res["grow"]:
        f = g["frame"]
        g.update(grow_call_ms=records[f]["ms"], next_call_ms=records[f + 1]["ms"] if f + 1 < len(records) else None,
                 next_call_captures=records[f + 1]["captures"] if f + 1 < len(records) else None,
                 third_call_ms=records[f + 2]["ms"] if f + 2 < len(records) else None)
    closures = [r["call"] for r in records if r["closure"]]
    kf_doublings = [g for g in res["grow"] if g["to"][0] == 2 * g["frm"][0]]
    mp_doublings = [g for g in res["grow"] if g["to"][1] == 2 * g["frm"][1]]
    spans = _span_ms(slam)
    summary = dict(
        res, wall_s=wall_s, lap=SCALE_LAP, radius_m=SCALE_RADIUS, closure_calls=closures,
        after_closures=_after_closures(records),
        kf_doublings=len(kf_doublings), mp_doublings=len(mp_doublings),
        captures=graphs.captures, capture_log=graphs.capture_log, replay_vs_eager=st["compared"],
        **_ms_stats(records, closures),
        keyframe_span_ms={k: dict(n=len(v), median=statistics.median(v), max=max(v))
                          for k, v in spans.items()},
        peak_mem_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
    )
    print(f"[14/14] c. scale run: {json.dumps(summary)}", flush=True)
    problems = list(st["bad"])
    if not kf_doublings or not res["pcg_essential_in_system"]:
        problems.append(f"keyframe store {res['start_capacity'][0]} → {res['final_capacity'][0]}: "
                        f"no doubling past 256 slots")
    if res["lost"]:
        problems.append(f"{res['lost']} frames lost")
    if not any(c >= SCALE_LAP for c in closures):
        problems.append(f"no closure on the second lap (closures at calls {closures})")
    if kf_doublings and not any(c["call"] > kf_doublings[0]["frame"] for c in st["compared"]):
        problems.append(f"no replay compared with eager after the keyframe store doubled: {st['compared']}")
    if problems:
        raise AssertionError(f"scale run: {problems}")
    return launches, summary


def run_long(base: SLAMConfig) -> list:
    """Phase 14: the adversarial world synchronous (a) and pipelined (b),
    then the scale run (c).  Returns the three runs' launch counts."""
    from orb_slam2_ros2_tpu_torch.io.synthetic import AdversarialStereoDataset

    t0 = time.perf_counter()
    ds = AdversarialStereoDataset(base.camera, n_frames=ADV_FRAMES, frames_per_lap=ADV_LAP, device="cuda")
    frames = _Frames(ds, ADV_FRAMES)   # rendered on the card, set-up
    render_s = time.perf_counter() - t0
    a_launches, a = run_adversarial(base, frames, ADV_FRAMES, "a. adversarial, synchronous", kidnap=True)
    pipe_cfg = base.replace(tracking=dataclasses.replace(base.tracking, pipelined=True))
    b_launches, b = run_adversarial(pipe_cfg, frames, ADV_FRAMES, "b. adversarial, pipelined", kidnap=False)
    print(f"[14/14] a/b: {ADV_FRAMES} frames each ({render_s:.1f} s to render), keyframes "
          f"{a['keyframes_inserted']} / {b['keyframes_inserted']}, wall {a['wall_s']:.3f} / {b['wall_s']:.3f} s, "
          f"closures {a['closures']} / {b['closures']}, frame-level queries {a['frame_loop_queries']} / "
          f"{b['frame_loop_queries']}, weak-frame recoveries {a['weak_frame_recoveries']} / "
          f"{b['weak_frame_recoveries']}, ATE live {a['ate_live_m']:.4f} / {b['ate_live_m']:.4f} m final "
          f"{a['ate_final_m']:.4f} / {b['ate_final_m']:.4f} m on {a['path_len_m']:.2f} m, launches "
          f"{a_launches} / {b_launches}", flush=True)
    del frames
    c_launches, c = run_scale(base)
    print(f"[14/14] c: {c['frames']} frames, {c['keyframes_inserted']} keyframes, grows "
          f"{[(g['frame'], g['frm'], g['to']) for g in c['grow']]}, closures at {c['closure_calls']}, "
          f"{c['captures']} captures, {len(c['replay_vs_eager'])} replays bit-equal to eager, fps "
          f"{[p['fps'] for p in c['fps_curve']]}, map {c['final_map_mb']} MB, peak device memory "
          f"{c['peak_mem_mib']:.1f} MiB, {c['wall_s']:.1f} s, launches {c_launches}", flush=True)
    return [a_launches, b_launches, c_launches]


def _frame_ms(records, keyframe=None):
    ms = [r["ms"] for r in records[2:]
          if not r.get("profiled") and (keyframe is None or r["keyframe"] == keyframe)]
    return statistics.median(ms) if ms else float("nan")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = gpu_line()
    print(f"[1/14] device: {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"[2/14] build: {build_s:.3f} s total, nvcc {json.dumps(_build.build_seconds)}", flush=True)
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
    print(f"[3/14] fast_nms: one launch over the canvas {tuple(k1_canvas.shape)} and one per "
          f"level, bit-equal to nms3(fast_score) on {len(levels)} levels "
          f"{[tuple(x.shape) for x in levels]}, nms on and off", flush=True)
    canvas, centers = k2_inputs(cfg, gen)
    k2_err = k2_check(canvas, centers)
    print(f"[4/14] patches: bit-equal to extract_patches_plain, canvas {tuple(canvas.shape)}, "
          f"{centers.shape[0]} centres", flush=True)

    records, launches, med = run_slice(cfg)
    print(f"[5/14] localization: {N_FRAMES} frames OK, median n_inliers(1-9) {med}, "
          f"max trans err {max(r['trans_err_m'] for r in records):.4f} m, launches {launches}",
          flush=True)
    map_records, map_launches, summary, map_slam, map_frames = run_mapping(map_cfg)
    map_summary = summary
    print(f"[6/14] mapping: {MAP_FRAMES} frames OK, {summary['new_keyframes']} keyframes after "
          f"keyframe 0, {summary['local_ba_runs']} local BAs, ATE live {summary['ate_live_m']:.4f} m "
          f"final {summary['ate_final_m']:.4f} m on a {summary['path_len_m']:.2f} m path, "
          f"launches {map_launches}", flush=True)

    map_poses = [p for _, p in map_slam.trajectory]
    map_summary.update(frame_ms_keyframe=_frame_ms(map_records, True), frame_ms_other=_frame_ms(map_records, False))
    reloc_cfg = map_cfg.replace(tracking=dataclasses.replace(map_cfg.tracking, only_tracking=True))
    reloc_records, reloc_launches, reloc = run_relocalization(map_slam, reloc_cfg, map_frames)
    print(f"[7/14] relocalization: {json.dumps(reloc)}, launches {reloc_launches}", flush=True)
    del map_slam, map_frames

    rgbd_cfg = rgbd_config(base)
    r_levels, r_canvas, r_table = k1_inputs(rgbd_cfg, gen, batch=1)
    k1_err = max(k1_err, k1_check(r_levels, r_canvas, r_table))
    r2_canvas, r2_centers = k2_inputs(rgbd_cfg, gen, batch=1)
    k2_err = max(k2_err, k2_check(r2_canvas, r2_centers))
    print(f"[8/14] RGB-D kernels: fast_nms bit-equal on the one-image canvas {tuple(r_canvas.shape)} "
          f"(one launch, and per level, nms on and off), patches bit-equal with "
          f"{r2_centers.shape[0]} centres", flush=True)
    rgbd_records, rgbd_launches, rgbd = run_rgbd(rgbd_cfg)
    print(f"[8/14] RGB-D: {RGBD_FRAMES} frames OK, {json.dumps(rgbd)}, launches {rgbd_launches}",
          flush=True)

    _, loop_launches, loop = run_loop(base)
    print(f"[9/14] loop closing: {loop['frames']} frames OK, closure at frame {loop['closure_frame']} "
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
    print(f"[10/14] localization frame ms (frames 2-{N_FRAMES - 1}): median {_frame_ms(records):.3f}, "
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
    print(f"[10/14] relocalization ms: save {reloc['save_ms']:.1f}, load (with rebuild) "
          f"{reloc['load_ms']:.1f}, rebuild alone {reloc['rebuild_ms']:.1f} "
          f"({reloc['kf_capacity']} slots, {reloc['n_words']} words), relocalizing frames "
          f"{[round(x, 1) for x in reloc['reloc_ms']]}, LOST frames "
          f"{[round(x, 1) for x in reloc['lost_ms']]}, tracked frames median "
          f"{reloc['track_ms_median']:.1f} | RGB-D frame ms (frames ≥ 2): keyframe median "
          f"{_frame_ms(rgbd_records, True):.3f}, other median {_frame_ms(rgbd_records, False):.3f} | "
          f"device ms on the RGB-D canvas: fast_nms {k1_rgbd_ms:.5f} (bound "
          f"{k1_bound_ms(r_table)[0] * 1e3:.3f} us), patches {k2_rgbd_ms:.5f}", flush=True)
    print(f"[10/14] device ms per call ({TIMED_RUNS} back-to-back): fast_nms (8 levels x 2 images, "
          f"one launch) {k1_ms:.5f} (per-level design {K1_OLD_MS}) vs plain {k1_plain:.4f}, bound "
          f"{k1_bound * 1e3:.3f} us ({k1_by}), share {k1_bound / k1_ms:.3f} | patches {k2_ms:.5f} "
          f"(before {K2_OLD_MS}) vs plain {k2_plain:.4f}, library canvas[rows, cols] {k2_lib:.5f}, "
          f"bound {k2_bound * 1e3:.3f} us ({k2_by}), share {k2_bound / k2_ms:.3f}", flush=True)

    pair_launches, pair = run_graph_vs_eager(cfg)
    print(f"[11/14] graph vs eager, localization: {N_FRAMES} frames bit-equal (poses, stats vectors, "
          f"local maps, map), {pair['captures']} capture; frame ms median eager "
          f"{pair['eager_ms_median']:.3f} graph {pair['graph_ms_median']:.3f}; one frame profiled: "
          f"{json.dumps(pair['profile'])}, launches {pair_launches}", flush=True)
    (eager_map_launches, pipe_launches), pipe = run_pipelined_vs_sync(map_cfg, map_summary, map_records)
    print(f"[11/14] mapping eager / graph / pipelined: {json.dumps(pipe)}, launches eager "
          f"{eager_map_launches} pipelined {pipe_launches}", flush=True)
    _, pipe_loop_launches, pipe_loop = run_loop(
        base.replace(tracking=dataclasses.replace(base.tracking, pipelined=True)), tag="11/14")
    print(f"[11/14] loop closing pipelined: {pipe_loop['frames']} frames in order, closure at call "
          f"{pipe_loop['closure_frame']} (edges {pipe_loop['loop_edges']}), GBA committed at call "
          f"{pipe_loop['commit_frame']}, ATE live {pipe_loop['ate_live_m']:.4f} m final "
          f"{pipe_loop['ate_final_m']:.4f} m on {pipe_loop['path_len_m']:.2f} m, {pipe_loop['n_keyframes']} "
          f"keyframes (sync {loop['n_keyframes']}), median frame {pipe_loop['median_frame_ms']:.1f} ms "
          f"(sync {loop['median_frame_ms']:.1f}), wall from call 6 {pipe_loop['wall_s_from_call_6']:.3f} s "
          f"(sync {loop['wall_s_from_call_6']:.3f}), launches {pipe_loop_launches}", flush=True)
    if abs(pipe_loop["n_keyframes"] - loop["n_keyframes"]) > 3:
        raise AssertionError(f"loop world: pipelined {pipe_loop['n_keyframes']} keyframes, "
                             f"sync {loop['n_keyframes']}")
    blackout_launches, blackout = run_pipelined_blackout(map_cfg)
    print(f"[11/14] pipelined blackout: {json.dumps(blackout)}, launches {blackout_launches}", flush=True)
    print(f"[11/14] relocalization (batched cascade) profiled: {json.dumps(reloc['reloc_profile'])}; "
          f"relocalizing frames {[round(x, 1) for x in reloc['reloc_ms']]} ms, inliers "
          f"{[r['n_inliers'] for r in reloc_records if r['kind'] == 'reloc']}, errors "
          f"{[round(r['trans_err_m'], 4) for r in reloc_records if r['kind'] == 'reloc']} m", flush=True)

    probe = probe_shell()
    print(f"[12/14] probe: {json.dumps(probe)}", flush=True)
    shell_launches, shell = run_shell(base, probe)
    ran = [p for p in shell if p["ran"]]
    summary = {p["part"]: {k: p.get(k) for k in ("tracked", "frame_ms_median", "frame_ms_p90", "fps",
                                                  "save_ms", "load_ms", "saved_bytes", "decoded")}
               for p in ran}
    print(f"[12/14] shell: {len(ran)} parts passed, not run: "
          f"{[p['part'] + ' (' + p['why'] + ')' for p in shell if not p['ran']]}; {json.dumps(summary)}",
          flush=True)

    multi_launches, _ = run_multi_device(base, map_cfg, loop, map_summary, map_poses)
    print(f"[13/14] multi-device done at {time.perf_counter() - t_start:.1f} s", flush=True)

    long_launches = run_long(base)

    runs_launches = (launches, map_launches, reloc_launches, rgbd_launches, loop_launches,
                     pair_launches, eager_map_launches, pipe_launches, pipe_loop_launches,
                     blackout_launches, *shell_launches, *multi_launches, *long_launches)
    # launches: the wrappers' own (eager frames, first frames of graphs,
    # frontends of frames without a frame program) plus one a replay of a
    # frame graph — every run that replays had one of its replays traced by
    # the profiler, with each kernel once inside it
    replays = sum(x["replays"] for x in runs_launches)
    counts = {}
    for name in ("fast_nms", "patches"):
        eager = sum(x[name] for x in runs_launches)
        counts[name] = dict(launches=eager + replays, launches_by_wrapper=eager,
                            launches_in_graph_replays=replays,
                            graph_replays_profiled=_replays["profiled"])
        if eager < 1 or replays < 1:
            raise AssertionError(f"{name}: {eager} wrapper launches, {replays} graph replays on the main path")
    kernels = [
        {"name": "fast_nms", "route": "cuda", "source": "orb_slam2_ros2_tpu_torch/csrc/fast_nms.cu",
         "replaces": "orb_slam2_ros2_tpu/ops/pallas_fast.py:109", **counts["fast_nms"],
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None, "bound_us": k1_bound * 1e3,
         "share": k1_bound / k1_ms},
        {"name": "patches", "route": "cuda", "source": "orb_slam2_ros2_tpu_torch/csrc/patches.cu",
         "replaces": "orb_slam2_ros2_tpu/ops/pallas_patches.py:116", **counts["patches"],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": k2_lib, "bound_us": k2_bound * 1e3,
         "share": k2_bound / k2_ms},
    ]
    print(f"[done] total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
