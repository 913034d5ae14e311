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
     4096 centres, corners and clamp edges included — bit-equal; then K3
     ``brief`` on those 4096 patches against the dense product
     (``describe_plain``): a bit may differ only where the dense score is
     within 1e-4 of zero (the two sum in other orders; the tests hold K3 to
     an emulation of its own order bit for bit);
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
     essential graph takes the PCG route, captured at the loop programs'
     warm-up) on the circle world of
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
     the same windows, for K3 the f32 GEMM the dense product makes;
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
     ran.  Then ``tum`` on a 20-frame TUM RGB-D layout of phase 8's world
     (``rgb/`` 8-bit and ``depth/`` 16-bit PNGs written here in phase 8's
     sensor units, ``associate.txt``, ``groundtruth.txt``) with phase 8's
     configuration as ``--config`` YAML, gated as the ``kitti`` runs.  A
     part whose library the probe found missing prints ``"ran": false`` and
     why, and is not run; the ``kitti`` runs pass no ``--config``;
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
        slots (one process on one device: ``Mesh.capturable``, so the
        sharded GBA chunk and the essential graph's sharded GN step replay
        CUDA graphs): phase 9's gates, the sharded essential-graph steps
        and sharded GBA chunks counted (the graphs' replays plus the runs
        outside a capture), keyframes within ±3 of phase 9's, the
        ``optimize_essential`` and ``gba_chunk`` spans beside phase 9's and
        the graphs' captures; the closure's chunks and essential-graph
        inputs are kept for phase 19;
     c. the tracker/mapper split over phase 6's world: phase 6's gates,
        every frame ``OK``, each kernel once a frame (the tracker program
        replayed as a graph on the tracker device, call 5 traced, and the
        bookkeeping as a graph on the map device), the largest pose
        difference from phase 6's graph run within 5e-4, frame ms and the
        keyframe-program and ``bookkeep`` spans beside phase 6's, the
        split's captures and bookkeeping replays;
     d. two processes on ``cuda:0`` joined over gloo through the
        ``SLAM_*`` variables (``entry.run_ranks``), one shard each of part
        a's problems: each rank's result against the one-process 2-shard
        mesh's (bit-equality printed; the CPU tests' tolerances gated); each
        rank raises if it finds its mesh capturable (the route that stays
        eager).

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
 15. the remaining surface (the default ``SLAMConfig()``): (a) the one-image
     extractor (``make_extractor``) on one rendered frame: K1 and K2 once,
     its output bit-equal to the same call with the plain twins swapped in
     (by ``_Spy``), and ``fast_score_dispatch`` / ``fast_score_nms_dispatch``
     bit-equal to ``fast_score`` / ``nms3(fast_score)`` on that image; (b)
     ``OdometryTracker`` over 30 frames of the forward world at 0.35 m/frame
     (every frame tracked, ATE under 5% of the path), then the fused
     odometry step eagerly and replayed from its CUDA graph in turns,
     bit-equal, both under ``set_sync_debug_mode("error")``; the graph's
     nodes (its ``debug_dump``) hold K1 and K2 once each, and one replay is
     traced (its kernel records printed); (c) ``solve_ba`` on a local-BA-sized
     grid problem made on the card from a seeded generator (16 cameras, 2
     fixed, 512 stereo slots each, 4096 point slots, 2048 points seen by 4
     cameras each, 5% outliers): the robust
     cost falls and the clean edges' median χ² falls tenfold, the fixed
     cameras keep their bits, no host
     synchronisation, and the CPU copy agrees within 1e-4 m / 1e-3°, 1e-3 m
     on the points that keep an inlier edge, and equal gates; ms and peak
     memory; (d)
     ``train_corpus_vocab.main`` at the full image size on 4 frame pairs of
     each of its five worlds with the tree cut to depth 2, K1 over the
     four-image table and one batch's descriptors held to the plain twins;
     (e) the system's tracer (``SLAM.time_programs``) over phase 6's first
     10 frames: host spans ``frontend``, ``dispatch``, ``map_front`` and
     ``map_tail`` and device spans of every frame-graph replay and keyframe
     front, each of positive length.
 16. keyframe and closure graphs (every phase above already runs the
     keyframe programs and the single-process essential graph as CUDA
     graphs): (a) phase 6's mapping world with every keyframe program that
     fires run first eagerly on a clone of the map storage, then through
     the SLAM's ``KeyframeGraphs`` under sync debug "error": the storage
     and the outputs bit-equal; one capture a program; its first replay
     traced beside the eager program's trace (one graph launch, no kernel
     launched by the host beyond input copies, id fills and output clones);
     printed: eager and replay spans, capture ms, the memory the graphs
     hold and the peak; (b) phase 9's closure (its essential-graph inputs
     kept by a spy during phase 9) through a fresh ``EssentialGraph``:
     every call bit-equal to the eager ``optimize_essential``, one under
     sync debug "error", one traced (22 graph launches: the problem, 20 GN
     steps, the commit); printed: phase 9's span and its warm-up capture
     beside the eager program's 2.9-3.7 s (``EAGER_ESSENTIAL_S``), each
     part's capture ms and the memory held; (c) phase 14c's wall time and
     fps curve beside the eager keyframe programs' (``EAGER_SCALE``).
 17. the background GBA and the relocalization as graphs (every phase above
     already runs them so: the chunk and commit as ``global_ba.GBAGraphs``,
     the query and cascade as ``frame_graph.RelocGraph``, captured at the
     loop programs' warm-up or a map load): (a) phase 9's closure (the
     chunks of its snapshot and its commit, kept by a spy during phase 9)
     through a fresh ``GBAGraphs`` and through the same wrappers run
     eagerly: every chunk, ungated and gated through one graph, and the
     commit bit-equal (the commit also to ``commit_global_ba``), a chunk
     under sync debug "error", one replay traced (1 graph launch, at most
     ``GBA_HOST_LAUNCHES`` host launches) beside the unbucketed eager
     chunk's trace; printed: each chunk's eager, replay and unbucketed
     spans and the unbucketed chunk's largest difference, the first call
     (eager run + capture), the memory the graphs hold, phase 9's captures
     and replay spans; (b) the relocalizations of phases 7 and 14a (their
     inputs kept by a spy): each ran as a replay of the warm-up's capture,
     and each replay of a fresh ``RelocGraph`` is bit-equal to the eager
     run and to the pose the phase returned; one eager run and one replay
     under sync debug "error", one replay traced (1 graph launch) beside
     the eager trace; printed: eager and replay spans, the relocalizing
     frames' ms (median, max) beside the eager 208-309 ms, capture ms and
     memory; (c) the GBA captures across phase 14c's closures and grows.
 18. the loop closer's remaining programs as graphs (every phase above
     already runs them so: detection, the frame query, the Sim3 stages A,
     B and C, the correction's front and each loop-group fuse as
     ``loop_closing.LoopGraphs``, captured at the loop programs' warm-up
     and after a grow, under sync debug "error" from call 2 of phases 9
     and 14): (a) the newest call of each program in phase 9 (its inputs
     kept by ``_LoopCalls``) and the closure's front with its fuses in
     order, through a fresh ``LoopGraphs`` and through the same wrappers
     run eagerly: every call bit-equal (outputs, the map and the
     database), one replay of each under sync debug "error", one traced
     (1 graph launch, at most ``LOOP_HOST_LAUNCHES`` host launches) beside
     the eager trace; printed: eager and replay spans, each program's first
     call (eager run + capture), the memory the graphs hold, phase 9's
     captures and replay spans; (b) the closure frame's ``correct`` in its
     parts (``correct_front``, the covisibility read, the fuses,
     ``optimize_essential``) and the spike ratios of phases 9 and 14c
     beside the eager stages' (``EAGER_LOOP``); (c) the loop-graph
     captures over phase 14c's grows and 14c's peak device memory.
 19. the mesh and split graphs (phase 13b and c already run them so): (a)
     every chunk of 13b's closure (kept by ``_GBACalls``), ungated and
     gated, over the 2-slot mesh through a fresh ``GBAGraphs`` and through
     the same wrappers run eagerly, bit-equal, a chunk under sync debug
     "error", one replay traced (1 graph launch, at most
     ``GBA_HOST_LAUNCHES`` host launches) beside the trace of the eager
     ``step_global_ba`` over the mesh (the route before these graphs), and
     a second snapshot of the same bucket (moved poses and points) against
     its own eager run; (b) 13b's closure (kept by ``_EssentialCalls``)
     through a fresh ``EssentialGraph`` over the mesh, bit-equal to the
     eager ``_essential_mesh``, one replay under sync debug "error", one
     traced (22 graph launches), and a second closure (another pair and
     Sim3) against the same wrappers run eagerly; (c) 13c's world again, every bookkeeping
     call checked as it comes through a fresh ``KeyframeGraphs`` and its
     eager wrapper on copies of the map storage: outputs and storage
     bit-equal, the replays under sync debug "error", one traced (1 graph
     launch); the run's poses bit-equal to 13c's; (d) the route of a mesh
     that ``Mesh.capturable`` refuses, on the one card through the slots
     ``["cuda", "cuda:0"]`` (two devices to the rule, one card to CUDA):
     13b's closure through ``EssentialGraph`` over it (problem and commit
     captured and replayed, the 20 sharded GN steps eager between them)
     and 13b's chunks through ``GBAGraphs.step`` over it (the system's
     chunk: ``step_global_ba``, eagerly), each bit-equal to the eager
     programs over 13b's mesh, then the last chunk's iterate through the
     commit graph against ``commit_global_ba``.  Printed: replay and eager
     spans, each graph's first call (eager run + capture), the memory it
     holds, and (d) the eager sharded steps and chunks.
 20. the measurement tools (``orb_slam2_ros2_tpu_torch/tools``): every
     tool's ``main`` in this process on the card with ``TOOL_ARGS`` (the
     JAX scripts' depths; ``bench_posegraph`` once at its sizes and once at
     K=64), one tool's graphs dropped and the cache emptied before the
     next.  Gates (``check_tool``): every tool returns its keys and every
     time in them is finite and positive; ``profile_frame``'s full step no
     faster than its frontend; K1 and K2 once a replay in ``profile_trace``'s
     trace; ``bench_posegraph``'s 20 ``gn_step`` replays bit-equal to the
     eager ``optimize_pose_graph`` on every route and size, every solve's
     cost under a tenth of its start, the dense route's cost no higher than
     PCG's, and the two routes' poses within 2e-3 at K=64 (past K ≈ 100 the
     150 CG iterations a step stop short of the dense optimum); every
     ``bench_io`` load equal to the saved map; ``profile_orbvoc``'s second
     run on 10⁶ words; every frame tracked in ``profile_full``,
     ``profile_loop`` and both ``profile_orbvoc`` runs.  The K1 and K2 runs
     inside the tools' graph replays are counted per kernel
     (``tools._timing.graph_kernels``).
 21. the benches, in this process at the JAX scripts' sizes: (a)
     ``tools.bench`` (full SLAM over 84 frames of the KITTI-like world, then
     the 80-frame return pass replayed through the SLAM's frame graph with
     its state carried, an untimed run and 3 timed; the local-BA window
     solve) with ``tools.bench_full`` as its subprocess (40 warm and 80
     timed pipelined frames); gates: exit code 0, median inliers ≥ 300,
     the subprocess's exit code 0, its ATE gate passed and every timed
     frame tracked, K1 and K2 once in
     each of the ≥ 320 return-pass replays; (b) ``tools.bench_loop`` (two
     laps of the 100-frame circle): a closure and a finite spike ratio; (c)
     ``tools.bench_scaling`` (C=1024, P=200,000, O=6 solved unsharded and
     over 2, 4 and 8 slots of the card, once each after an untimed solve):
     every time positive, every cost finite, every solve's robust cost
     (the gated Huber cost it minimises) below the start's, and each
     sharded solve's cameras within 1e-4 m / 1e-3° of the unsharded
     solve's; then the same mesh sizes on the dry run's corridor at phase
     13a's C=256, P=25,000 with ``bench_scaling``'s settings, each sharded
     solve against the unsharded one: in float64 every camera within
     1e-4 m / 1e-3°, every point within 1 mm + 2e-4 and the gates within
     2 (``tests/test_torch_sharded_solvers.py``'s tolerances); in float32
     within 5 mm / 0.01°, a point excess of 2 mm and 2 gates, the rounding
     floor of a problem whose last cameras see few points or none (the
     unsharded solve of the points reordered is printed beside them).
     Each bench's lines, the phase's seconds and its launches are printed.
 22. the last paths the JAX package flies: (a) ``configs/tum_fr2.yaml`` as
     shipped (640×480, its five distortion coefficients, 2000 features,
     ``th_depth`` 40): phase 8's world rendered with its pinhole
     intrinsics, then each frame warped into the lens on the card
     (``warp_to_distorted``, the counterpart of
     ``tests/test_distorted_e2e.py``'s warp: intensity bilinear, depth
     nearest, zero outside), ``SLAM(rgbd=True)`` on the pinhole frames
     (the configuration without its lens) and on the warped frames (the
     configuration itself); gates: every frame ``OK``, each run one
     capture, frames ≥ 2 free of host syncs, each kernel once a frame, the
     distorted ATE under max(2.5 × the pinhole run's, 3% of the path) and
     phase 8's 4%, more than 300 map points; printed: both runs' frame ms
     and the device ms of one replay of each frame graph, the
     undistortion's device ms alone (as a graph), the keypoints whose
     undistorted ``uv`` left the image; (b) ``cli tum --config configs/tum_fr2.yaml``
     (the file itself) on a TUM layout of the warped frames, gated as
     phase 12's ``tum`` run; (c) ``tests/test_slam_e2e.py``'s noise at the
     default ``SLAMConfig()``: 25 frames of the default world at 0.35
     m/frame with σ = 6 grey levels of Gaussian noise on both images,
     drawn on the card from a seeded generator before each call; gates:
     ≥ 90% tracked, ATE under 8% of the path; (d) phase 6's world with
     one frame forced weak (``min_localmap_matches`` 10⁶ and no keyframe
     on the call that resolves it, after ≥ 2 keyframes), synchronous and
     pipelined on the graph; gates: the reference-keyframe fallback
     recovers it within 0.05 m, every frame ``OK``, the weak call traced
     (each kernel once a frame-program run); pipelined, the successor
     re-dispatched as one replay and no capture on the local map the weak
     frame was dispatched with, the poses within 1 cm / 0.1° of the
     synchronous run's; (e) ``entry.dryrun_multichip(1)`` with no devices
     named runs on the card.

Before the last line come the run's total seconds, a JSON object with one
entry per kernel and the card line; the last line is ``{"ok": true, "device": {...}}``.  A kernel's
``launches``, summed over the main-path runs of every phase, is its
wrapper's count (``launches_by_wrapper``) plus one a graph replay
(``launches_in_graph_replays``, the tools' and the benches' replays of
phases 20 and 21 counted per kernel); ``launches_in_tools`` and
``launches_in_benches`` are phase 20's and 21's shares and
``graph_replays_profiled`` counts the replays the profiler saw.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
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
from orb_slam2_ros2_tpu_torch.ops import _build, brief, fast, patches
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
KERNELS = ("fast_nms", "patches", "brief")  # K1, K2, K3 by the names of their wrappers' counts
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
SHELL_TUM_FRAMES = 20    # the tum layout: phase 8's world and length
SHELL_PROFILED_CALL = 10  # the traced call of each CLI run: a replay after the
#                          loop programs' warm-up (call 5 or 6 of a mapping run)
# multi-device phase: two mesh slots, or the tracker's and the map's device,
# on the one card
MULTI_DEVICES = ["cuda:0", "cuda:0"]
# the same card as two devices to Mesh.capturable: a mesh the rule refuses
REFUSED_MESH_DEVICES = ["cuda", "cuda:0"]
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
# the remaining surface (phase 15)
ODO_FRAMES = 30          # odometry frames (tests/test_odometry_e2e.py)
SBA_CAMS, SBA_FIXED, SBA_SLOTS, SBA_POINTS = 16, 2, 512, 4096   # local-BA size
SBA_VIEWS = 4            # cameras observing each observed point
SBA_OUTLIERS = 0.05
CORPUS_PAIRS = 4         # frame pairs a world (the packaged corpus: every pair)
CORPUS_DEPTH = 2         # tree depth (the packaged vocabulary: 5)
PROFILE_FRAMES = 10
# keyframe and closure graphs (phase 16): the eager figures they replace,
# measured by this script on an NVIDIA H100 80GB HBM3 at 700 W at commit
# 11141c4 (optimize_essential a closure over its runs; phase 14c)
EAGER_ESSENTIAL_S = (2.9, 3.7)
EAGER_SCALE = dict(wall_s=107.6, fps=[7.94, 7.93, 8.30, 6.62, 7.80, 8.14, 4.61])
# the GBA chunk and the relocalization as graphs (phase 17): the eager
# figures they replace, by this script on an NVIDIA H100 80GB HBM3 at 700 W
# (GBA chunk spans of phases 9 and 14 at commit 1a70968; a relocalizing
# frame of 14a's kidnappings and the cascade's kernel time at commit 418eaa8)
EAGER_GBA_CHUNK_MS = (115, 395)
EAGER_RELOC_FRAME_MS = (208, 309)
EAGER_CASCADE_KERNEL_MS = 36.7
# host kernel launches a traced replay may add: the pads, the copies of its
# inputs, the gate or id fills and the clones of its outputs
GBA_HOST_LAUNCHES = 20
RELOC_HOST_LAUNCHES = 20
LOOP_HOST_LAUNCHES = 30
LOOP_PROGRAMS = ("detect", "frame_detect", "sim3_a", "sim3_b", "sim3_c", "correct_front", "fuse_one")
# the loop closer's programs as graphs (phase 18): the eager stages they
# replace, by this script's run_loop and run_scale on an NVIDIA H100 80GB
# HBM3 at 700 W at commit 55dd11c (spans in ms; 14c's medians of 4 closures)
EAGER_LOOP = {
    "9": dict(loop_detect_median=1.286, sim3_a=[9.65, 9.739, 8.063, 1.114, 1.127], sim3_b=[56.705, 48.769],
              sim3_c=[7.312], correct_group=3.552, fuse=231.051, optimize_essential=701.863, correct=936.838,
              spike_ratio=26.02),
    "14c": dict(loop_detect_median=1.251, sim3_a_median=1.124, sim3_b_median=49.428, sim3_c_median=4.919,
                correct_group=2.581, fuse=201.115, optimize_essential=600.937, correct=795.842,
                spike_ratio=80.11, peak_mem_mib=3275.5),
}
# the mesh and split graphs (phases 13 and 19): the eager figures they
# replace, by this script's phase 13 on an NVIDIA H100 80GB HBM3 at 700 W at
# commit fd81c2a (13b's spans over the 2-slot mesh; 13c's bookkeep spans,
# median and max over 39 frames)
EAGER_MESH_SPAN_MS = dict(optimize_essential=[4456.73],
                          gba_chunk=[367.12, 394.741, 360.065, 387.694, 357.384, 351.072])
EAGER_BOOKKEEP_MS = dict(median=0.8695, max=8.334)
BOOKKEEP_HOST_LAUNCHES = 30


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


def k3_inputs(canvas, centers):
    """K2's patches of ``centers`` on ``canvas`` (as the extractor gathers
    them), their grey-centroid angles and bins, and K3's tables of the seeded
    template."""
    p = patches.extract_patches_48x64(canvas, centers)
    ang = brief.orientations(p, brief.moment_weights(canvas.device))
    return p, ang, brief.angle_bins(ang), brief.operator(canvas.device)


def k3_check(p, ang, k3, D) -> int:
    """Raises unless K3's bits equal the dense product's (``describe_plain``)
    wherever the dense score is not within 1e-4 of zero (the two sum in other
    orders); returns how many bits differ."""
    got = brief.describe(p, ang, k3)
    want = brief.describe_plain(p, ang, D)
    n = p.shape[0]
    scores = (p.reshape(n, -1).to(torch.bfloat16).float() @ D).reshape(n, brief.N_ANGLE_BINS, -1)
    scores = scores[torch.arange(n, device=p.device), brief.angle_bins(ang).long()]
    diff = (((got ^ want).long()[..., None] >> torch.arange(32, device=p.device)) & 1).bool().reshape(n, -1)
    torch.cuda.synchronize()
    if bool((scores[diff].abs() >= 1e-4).any()):
        raise AssertionError(f"brief: {int(diff.sum())} bits differ from the dense product, some far from a tie")
    return int(diff.sum())


def k3_bound_ms(p) -> tuple:
    """(bound ms, "bytes") of K3: the f32 patches and the bins read once,
    the descriptors written once (K3's tables are its own encoding of the
    template, not an input of the job); its 256 x 98 multiply-adds a patch
    are far below the f32 peak."""
    n = p.shape[0]
    n_bytes = 4.0 * p.numel() + 4.0 * n + 32.0 * n
    return n_bytes / HBM_BYTES_PER_S * 1e3, "bytes"


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
    brief.brief_launches = 0
    _replays["run"] = 0


def _launches() -> dict:
    """The wrappers' launch counts (eager launches) and the frame-graph
    replays of the current run."""
    return {"fast_nms": fast.fast_nms_launches, "patches": patches.patch_launches,
            "brief": brief.brief_launches, "replays": _replays["run"]}


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
    k1, k2, k3 = (_launches()[k] - before[k] for k in KERNELS)
    if k1 != want or k2 != want or k3 != want:
        raise AssertionError(f"frame {label}: kernel launches fast_nms {k1}, patches {k2}, brief {k3}; "
                             f"this call ran {want} frame program(s) eagerly, {replays} replay(s)")
    _replays["run"] += replays
    if profile:
        seen = _kernel_counts(prof)
        if replays < 1 or seen != {"fast_nms": k1 + replays, "patches": k2 + replays, "brief": k3 + replays}:
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
        print(f"[5/22] frame {i}: {json.dumps(rec)}", flush=True)
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


def run_mapping(cfg: SLAMConfig, mode: str = "graph", tag: str = "6/22", devices=None):
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
        print(f"[7/22] {json.dumps(rec)}", flush=True)
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


def warp_to_distorted(cam, img: torch.Tensor, depth: torch.Tensor) -> tuple:
    """A pinhole render warped into the distorted camera's image plane, the
    counterpart of ``tests/test_distorted_e2e.py``'s ``_warp_to_distorted``:
    the distorted image at pixel u_d shows the pinhole content at u_p =
    ``undistort_points(cam, u_d)``, intensity bilinear, depth nearest (an
    interpolated depth across a discontinuity invents 3D points), zero where
    u_p leaves the image.  ``img`` and ``depth`` are [H, W] on ``cam``'s
    device."""
    from orb_slam2_ros2_tpu_torch.geometry.camera import undistort_points

    H, W = img.shape
    vv, uu = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=img.device),
                            torch.arange(W, dtype=torch.float32, device=img.device), indexing="ij")
    src = undistort_points(cam, torch.stack([uu.reshape(-1), vv.reshape(-1)], dim=-1))
    x, y = src[:, 0], src[:, 1]
    inb = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    # out-of-image (and diverged, non-finite) sources are masked; clamp
    # their indices into the image first
    xc = torch.nan_to_num(x, nan=0.0).clamp(-1.0, float(W))
    yc = torch.nan_to_num(y, nan=0.0).clamp(-1.0, float(H))
    x0 = torch.floor(xc).long().clamp(0, W - 2)
    y0 = torch.floor(yc).long().clamp(0, H - 2)
    fx_ = (x - x0).clamp(0.0, 1.0)
    fy_ = (y - y0).clamp(0.0, 1.0)
    i00, i01 = img[y0, x0], img[y0, x0 + 1]
    i10, i11 = img[y0 + 1, x0], img[y0 + 1, x0 + 1]
    val = (1 - fy_) * ((1 - fx_) * i00 + fx_ * i01) + fy_ * ((1 - fx_) * i10 + fx_ * i11)
    img_d = torch.where(inb, val, 0.0).reshape(H, W)
    xn = torch.round(xc).long().clamp(0, W - 1)
    yn = torch.round(yc).long().clamp(0, H - 1)
    dep = torch.where(inb, depth[yn, xn], 0.0).reshape(H, W)
    return img_d, dep


def rgbd_frames(cfg: SLAMConfig, warp_cam=None) -> list:
    """Phase 8's world at ``cfg``'s camera, rendered on the card with its
    pinhole intrinsics: (RGB image, depth map in sensor units, Twc) a
    frame, the default world shrunk by ``RGBD_WORLD_SCALE``; with
    ``warp_cam`` each frame warped into that camera's lens
    (``warp_to_distorted``)."""
    ds = SyntheticStereoDataset(cfg.camera, n_frames=RGBD_FRAMES, speed=SPEED, device="cuda")
    frames = []
    for i in range(RGBD_FRAMES):
        img, depth, Twc = ds.frame_with_depth(i)
        Twc = Twc.copy()
        Twc[:3, 3] *= RGBD_WORLD_SCALE
        depth = depth * (RGBD_WORLD_SCALE * cfg.camera.depth_scale)
        if warp_cam is not None:
            img, depth = warp_to_distorted(warp_cam, img, depth)
        frames.append((img[:, :, None].expand(-1, -1, 3).contiguous(), depth, Twc))
    return frames


def run_rgbd(cfg: SLAMConfig, frames=None, tag: str = "8/22"):
    """RGB-D SLAM (no loop closing) at the TUM fr2 size over ``frames``
    (``rgbd_frames(cfg)`` by default: RGB images and depth maps in sensor
    units of the default world shrunk by ``RGBD_WORLD_SCALE``).  Returns
    (records, launch counts, summary); the summary also counts, a frame,
    the valid keypoints whose undistorted ``uv`` left the image, and times
    one replay of the frame graph on the device."""
    frames = rgbd_frames(cfg) if frames is None else frames  # rendered on the card, set-up
    W, H = cfg.camera.width, cfg.camera.height
    slam = SLAM(cfg, rgbd=True, enable_loop_closing=False, device="cuda")
    torch.cuda.synchronize()

    _reset_launches()
    records, outside = [], []
    for i, (rgb, depth, Twc_gt) in enumerate(frames):
        n_kf_before = slam._n_kf
        slam.frame_sync_debug_mode = "error" if i >= 2 else None
        pose, stats, ms = _track(slam, i, rgb, depth, profile=i == PROFILED_CALL)
        if slam.state != TrackState.OK or pose is None:
            raise AssertionError(f"[{tag}] frame {i}: state {slam.state}, stats {stats}")
        feats = slam.last.frame.feats
        u, v = feats.uv[:, 0], feats.uv[:, 1]
        outside.append((feats.valid & ((u < 0) | (u > W - 1) | (v < 0) | (v > H - 1))).sum())
        rec = dict(frame=i, ms=ms, profiled=i == PROFILED_CALL, keyframe=slam._n_kf > n_kf_before,
                   n_inliers=stats.get("n_inliers"),
                   n_kf=slam._n_kf, n_mappoints=stats.get("n_mappoints"),
                   trans_err_m=_trans_err(pose, Twc_gt))
        print(f"[{tag}] frame {i}: {json.dumps(rec)}", flush=True)
        records.append(rec)
    slam.flush()
    torch.cuda.synchronize()
    slam.frame_sync_debug_mode = None
    launches = _launches()
    gt = [f[2] for f in frames]
    ate = ate_rmse([np.linalg.inv(T.astype(np.float64)) for _, T in slam.trajectory], gt)
    path_len = float(sum(np.linalg.norm(gt[i + 1][:3, 3] - gt[i][:3, 3]) for i in range(len(frames) - 1)))
    summary = dict(ate_m=ate, path_len_m=path_len, n_keyframes=slam.n_keyframes,
                   frame_graph_captures=_captures(slam),
                   n_mappoints=slam.n_mappoints, init_mappoints=records[0]["n_mappoints"],
                   uv_outside_image=torch.stack(outside).tolist(),
                   replay_device_ms=_frame_graph_device_ms(slam))
    if not ate < MAX_ATE_RGBD * path_len:
        raise AssertionError(f"[{tag}] RGB-D ATE {ate:.4f} m ≥ {MAX_ATE_RGBD} × {path_len:.3f} m")
    return records, launches, summary


def _frame_graph_device_ms(slam: SLAM) -> float:
    """Device ms of one replay of the SLAM's one captured frame graph, timed
    after its run (the replays bump the map's counters again): 20 replays
    back to back with no sleep ahead, since a frame graph's nodes fill the
    launch queue and the host then waits on the device, which stays busy."""
    (step, _), = slam._frame_graphs._steps.values()
    (captured,) = step._graphs.values()
    return device_ms(captured.graph.replay, runs=20, warmup=2, queue_ahead=False)


def _span_ms(slam: SLAM) -> dict:
    """CUDA-event spans of the SLAM's programs by name: [ms, ...]."""
    spans: dict = {}
    for name, start, end in slam.program_events:
        spans.setdefault(name, []).append(start.elapsed_time(end))
    return spans


def run_loop(cfg: SLAMConfig, tag: str = "9/22", devices=None):
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
        graphs=_solver_graph_counts(slam),
    )
    print(f"[{tag}] loop{' pipelined' if pipelined else ''}: {json.dumps(summary)}", flush=True)
    if not ate_live < MAX_ATE_LIVE * path_len:
        raise AssertionError(f"loop live ATE {ate_live:.4f} m ≥ {MAX_ATE_LIVE} × {path_len:.2f} m")
    if not ate_final < MAX_ATE_FINAL * path_len:
        raise AssertionError(f"loop final ATE {ate_final:.4f} m ≥ {MAX_ATE_FINAL} × {path_len:.2f} m")
    if not ate_final <= ate_live:
        raise AssertionError(f"loop final ATE {ate_final:.4f} m worse than live {ate_live:.4f} m")
    return records, launches, summary


def _solver_graph_counts(slam: SLAM) -> dict:
    """The captures and replays of the SLAM's GBA graphs (the chunk's
    capture log names its shard count) and of its essential graph's GN
    step part (the graph of the last mesh asked for)."""
    gba = slam._gba_graphs
    ess = slam.loop_closer.essential if slam.loop_closer is not None else None
    return dict(gba_capture_log=list(gba.capture_log), gba_chunk_replays=gba.chunk_replays,
                gba_commit_replays=gba.commit_replays, gba_eager_chunks=gba.eager_chunks,
                essential_shards=ess.mesh.size if ess is not None and ess.mesh is not None else 1,
                essential_step_captures=ess.parts[1].captures if ess is not None else 0,
                essential_step_replays=ess.parts[1].replays if ess is not None else 0)


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
            if any(f"{name}_kernel" in e.key for name in KERNELS):
                kernels[e.key] = e.count
    launches = sum(n for k, n in api.items() if "LaunchKernel" in k)
    return dict(launches=launches, graph_launches=sum(n for k, n in api.items() if "GraphLaunch" in k),
                device_kernels=dev_kernels, api=api, kernels=kernels, kernel_ms=dev_us / 1000.0,
                wall_ms=wall, result=result)


def _kernel_counts(prof: dict) -> dict:
    """K1, K2 and K3 runs the device made in a profile, by kernel."""
    return {name: sum(n for k, n in prof["kernels"].items() if f"{name}_kernel" in k) for name in KERNELS}


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
    if g["graph_launches"] != 1 or len(g["kernels"]) != len(KERNELS) or k_counts != [1] * len(KERNELS):
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
    eager_records, eager_launches, eager, _, _ = run_mapping(cfg, "eager", "11/22")
    pipe_records, pipe_launches, pipe, pipe_slam, _ = run_mapping(cfg, "pipelined", "11/22")
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


def write_png_gray(path: str, img: np.ndarray) -> None:
    """A greyscale PNG of a uint8 (8-bit) or uint16 (16-bit) image (filter 0
    on every row), written with zlib."""
    h, w = img.shape
    depth = 8 * img.dtype.itemsize
    rows = img.astype(">u2").view(np.uint8).reshape(h, 2 * w) if depth == 16 else img
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 0, 0, 0, 0))
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
            write_png_gray(os.path.join(root, d, f"{i:06d}.png"),
                            img.clamp(0, 255).to(torch.uint8).cpu().numpy())
        poses.append(Twc)
    with open(os.path.join(root, "times.txt"), "w") as f:
        f.write("".join(f"{0.1 * i:.6f}\n" for i in range(n)))
    write_kitti(os.path.join(root, "poses.txt"), poses)
    return path_length(poses)


def write_tum_layout(root: str, cfg: SLAMConfig, n: int, device="cuda", warp=None) -> float:
    """A TUM RGB-D sequence on disk (rgb/ depth/ associate.txt
    groundtruth.txt) of phase 8's world: 8-bit images, 16-bit depth maps in
    ``cfg``'s sensor units (0, no reading, past the 16-bit range), the
    ground truth scaled as phase 8 scales it; ``warp(img, depth)``, when
    given, maps each rendered pair first.  Returns its path length."""
    from orb_slam2_ros2_tpu_torch.io.trajectory import rotation_to_quat

    for d in ("rgb", "depth"):
        os.makedirs(os.path.join(root, d))
    ds = SyntheticStereoDataset(cfg.camera, n_frames=n, speed=SPEED, device=device)
    assoc, gt, poses = [], ["# timestamp tx ty tz qx qy qz qw"], []
    for i in range(n):
        img, depth, Twc = ds.frame_with_depth(i)
        if warp is not None:
            img, depth = warp(img, depth)
        Twc = Twc.copy()
        Twc[:3, 3] *= RGBD_WORLD_SCALE
        d = (depth * (RGBD_WORLD_SCALE * cfg.camera.depth_scale)).cpu().numpy()
        s = f"{1000.0 + 0.05 * i:.6f}"
        write_png_gray(os.path.join(root, "rgb", f"{s}.png"), img.clamp(0, 255).to(torch.uint8).cpu().numpy())
        write_png_gray(os.path.join(root, "depth", f"{s}.png"),
                       np.where(np.isfinite(d) & (d > 0) & (d < 65535), np.rint(d), 0).astype(np.uint16))
        assoc.append(f"{s} rgb/{s}.png {s} depth/{s}.png")
        q, t = rotation_to_quat(Twc[:3, :3]), Twc[:3, 3]
        gt.append(f"{s} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} {q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}")
        poses.append(Twc)
    for name, lines in (("associate.txt", assoc), ("groundtruth.txt", gt)):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(lines) + "\n")
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
        print(f"[12/22] synth (python -m ..., its launches are counted in its own process): "
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
            print(f"[12/22] {json.dumps(parts[-1])}", flush=True)
        if probe["matplotlib"] != "missing":
            runs.append(("viewer", ["--viewer", f"{tmp}/film", "--viewer-every", "10"], SHELL_LOST, None))
        else:
            parts.append(dict(part="viewer", ran=False, why="matplotlib missing"))
            print(f"[12/22] {json.dumps(parts[-1])}", flush=True)
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
            print(f"[12/22] {part}: {json.dumps(parts[-1])}", flush=True)
        # tum on a TUM RGB-D layout of phase 8's world, with phase 8's configuration as YAML
        if probe["yaml"] != "missing" and probe["PIL"] != "missing":
            t0 = time.perf_counter()
            tum_cfg = rgbd_config(cfg)
            path = write_tum_layout(f"{tmp}/tum", tum_cfg, SHELL_TUM_FRAMES)
            with open(f"{tmp}/tum.yaml", "w") as f:
                f.write(json.dumps({"camera": TUM_CAMERA, "tracking": TUM_TRACKING}))   # JSON is YAML
            layout_s = time.perf_counter() - t0
            args = ["--config", f"{tmp}/tum.yaml"]
            res = run_cli(["tum", "--seq", f"{tmp}/tum", "--device", "cuda", "--out", f"{tmp}/t", *args])
            _check_run("tum", res, SHELL_TUM_FRAMES, SHELL_LOST, path, f"{tmp}/t", min_keyframes=2)
            res["layout_write_s"] = layout_s
            launches.append(res["launches"])
            parts.append(dict(part="tum", ran=True, argv=args, path_len_m=path, **res))
        else:
            parts.append(dict(part="tum", ran=False, why="PyYAML or Pillow missing"))
        print(f"[12/22] tum: {json.dumps(parts[-1])}", flush=True)
    return launches, parts


# ------------------------------------------------------------ multi-device --

class _Spy:
    """Counts, while it is active, the calls of ``obj.name`` (a module's
    function or an instance's method) that ``pred(*args, **kw)`` picks
    (every call when ``pred`` is None), and in ``true`` the calls that
    returned something true (a tensor counts as true).  With ``replace`` the calls go to it instead
    (phase 15 swaps in the kernels' plain twins)."""

    def __init__(self, obj, name, pred=None, replace=None):
        self.obj, self.name, self.pred, self.calls, self.true = obj, name, pred, 0, 0
        self.orig, self.own = getattr(obj, name), name in vars(obj)
        self.target = replace or self.orig

    def __enter__(self):
        def spy(*a, **kw):
            self.calls += self.pred is None or bool(self.pred(*a, **kw))
            out = self.target(*a, **kw)
            self.true += torch.is_tensor(out) or bool(out)
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
    print(f"[13/22] a. dry run, 2 shards on one card: {json.dumps(dry)} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    if bad:
        raise AssertionError(f"the sharded solves left the one-shard solves' tolerances: {bad}")
    out["a"] = dry

    t0 = time.perf_counter()
    mesh_cfg = base.replace(dist=dataclasses.replace(base.dist, n_devices=2))
    with _Spy(pg_mod, "_gn_step_pcg_sharded", lambda *a, **kw: True) as pcg, \
            _Spy(gba_mod, "global_ba_phase", lambda *a, axis=None, **kw: axis is not None) as chunks, \
            _EssentialCalls() as ess13, _GBACalls() as gba13:
        _, loop_launches, lp = run_loop(mesh_cfg, tag="13/22", devices=MULTI_DEVICES)
    # the sharded work: the graphs' replays, plus the Python calls that ran
    # it (a graph's first call runs it eagerly, then calls it again to
    # record the capture, which runs nothing)
    g = lp["graphs"]
    chunk_captures = sum(1 for e in g["gba_capture_log"] if e[0] == "chunk" and e[2] > 1)
    steps = pcg.calls - g["essential_step_captures"] + g["essential_step_replays"]
    n_chunks = chunks.calls - chunk_captures + g["gba_chunk_replays"]
    spans = {k: {"mesh": lp["span_ms"].get(k), "phase 9": loop["span_ms"].get(k),
                 "eager mesh route (fd81c2a)": EAGER_MESH_SPAN_MS[k]}
             for k in ("optimize_essential", "gba_chunk")}
    b = dict(sharded_pcg_steps=steps, sharded_gba_chunks=n_chunks,
             python_calls=dict(pcg=pcg.calls, chunks=chunks.calls), graphs=g,
             closure_frame=lp["closure_frame"],
             n_keyframes=lp["n_keyframes"], phase9_keyframes=loop["n_keyframes"],
             ate_live_m=lp["ate_live_m"], ate_final_m=lp["ate_final_m"], path_len_m=lp["path_len_m"],
             median_frame_ms=lp["median_frame_ms"], phase9_median_frame_ms=loop["median_frame_ms"],
             peak_mem_mib=lp["peak_mem_mib"], spans_ms=spans, seconds=time.perf_counter() - t0)
    print(f"[13/22] b. loop world over a 2-shard mesh: {json.dumps(b)}", flush=True)
    # the loop programs' warm-up runs 20 sharded steps and 2 chunks, the
    # closure 20 steps and every chunk of the background solve; the mesh is
    # capturable, so every step after the warm-up's first and every chunk
    # but the first of each bucket replays a graph
    want = (2 * ESSENTIAL_ITERS, 2 + sum(base.loop.global_ba_phase_iters))
    if steps < want[0] or n_chunks < want[1]:
        raise AssertionError(f"the loop world ran {steps} sharded essential-graph steps and "
                             f"{n_chunks} sharded GBA chunks, fewer than {want}")
    if g["essential_shards"] != 2 or g["essential_step_replays"] < 2 * ESSENTIAL_ITERS - 1 or \
            g["gba_chunk_replays"] < sum(base.loop.global_ba_phase_iters) or g["gba_eager_chunks"]:
        raise AssertionError(f"the mesh route did not replay its graphs: {g}")
    if abs(lp["n_keyframes"] - loop["n_keyframes"]) > 3:
        raise AssertionError(f"mesh: {lp['n_keyframes']} keyframes, phase 9 {loop['n_keyframes']}")
    out["b"] = b

    t0 = time.perf_counter()
    split_cfg = map_cfg.replace(dist=dataclasses.replace(map_cfg.dist, tracker_mapper_split=True))
    recs, split_launches, sm, slam, _ = run_mapping(split_cfg, "split", "13/22", devices=MULTI_DEVICES)
    diff = max(float(np.abs(a - b).max()) for (_, a), b in zip(slam.trajectory, map_poses))
    kg = slam._kf_graphs
    bk = kg._steps.get("bookkeep")
    c = dict(pose_diff_vs_phase6=diff, within_5e4=diff <= SPLIT_POSE_ATOL,
             frame_ms_keyframe=_frame_ms(recs, True), frame_ms_other=_frame_ms(recs, False),
             wall_s_from_call_6=sm["wall_s_from_call_6"], phase6_wall_s_from_call_6=map_summary["wall_s_from_call_6"],
             phase6_frame_ms_keyframe=map_summary["frame_ms_keyframe"],
             phase6_frame_ms_other=map_summary["frame_ms_other"],
             new_keyframes=sm["new_keyframes"], phase6_new_keyframes=map_summary["new_keyframes"],
             ate_live_m=sm["ate_live_m"], ate_final_m=sm["ate_final_m"],
             spans_ms=sm["program_span_ms"], phase6_spans_ms=map_summary["program_span_ms"],
             eager_bookkeep_ms_before=EAGER_BOOKKEEP_MS, captures=sm["frame_graph_captures"],
             map_graph_captures=kg.captures, bookkeep_graph=dict(captures=bk.captures if bk else 0,
                                                                replays=bk.replays if bk else 0),
             map_device=str(slam.map_device), tracker_device=str(slam.device),
             seconds=time.perf_counter() - t0)
    print(f"[13/22] c. tracker/mapper split on one card: {json.dumps(c)}, launches {split_launches}", flush=True)
    if len(slam.trajectory) != MAP_FRAMES:
        raise AssertionError(f"the split tracked {len(slam.trajectory)} of {MAP_FRAMES} frames")
    if not diff <= SPLIT_POSE_ATOL:
        raise AssertionError(f"the split's poses left phase 6's by {diff} > {SPLIT_POSE_ATOL}")
    n_bookkeep = sm["program_span_ms"]["bookkeep"]["n"]
    if bk is None or bk.captures != 1 or bk.replays != n_bookkeep - 1:
        raise AssertionError(f"the split's bookkeeping: {c['bookkeep_graph']} over {n_bookkeep} frames "
                             f"(want 1 capture and a replay on every later frame)")
    out["c"] = c
    out["split"] = dict(cfg=split_cfg, poses=[p for _, p in slam.trajectory])
    del slam, kg, bk

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
    print(f"[13/22] d. two gloo ranks on one card against the one-process 2-shard mesh: {json.dumps(d)}",
          flush=True)
    out["d"] = d
    out["recorded"] = dict(gba=gba13, essential=ess13)
    out["b_loop"] = lp
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
    print(f"[14/22] {tag}: {json.dumps(summary)}", flush=True)
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
    counts = _launches()
    mapstate = MapState(*(t.clone() for t in slam.map))
    new_state, velocity, host_vec, mapstate, local = slam.frame_program(
        img_a, img_b, slam.last, slam.velocity, slam.local, mapstate, kf_index(slam.ref_kf, slam.device),
        proj_th=proj_th)
    fast.fast_nms_launches, patches.patch_launches, brief.brief_launches = (counts[k] for k in KERNELS)
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
        gba_capture_log=slam._gba_graphs.capture_log,
        **_ms_stats(records, closures),
        keyframe_span_ms={k: dict(n=len(v), median=statistics.median(v), max=max(v))
                          for k, v in spans.items()},
        peak_mem_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
    )
    print(f"[14/22] c. scale run: {json.dumps(summary)}", flush=True)
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


def run_long(base: SLAMConfig) -> tuple:
    """Phase 14: the adversarial world synchronous (a) and pipelined (b),
    then the scale run (c).  Returns the three runs' launch counts, the
    scale run's summary (with its GBA graphs' calls and (a)'s kidnapping
    frames' ms) and (a)'s relocalizations as ``_RelocCalls`` kept them."""
    from orb_slam2_ros2_tpu_torch.io.synthetic import AdversarialStereoDataset

    t0 = time.perf_counter()
    ds = AdversarialStereoDataset(base.camera, n_frames=ADV_FRAMES, frames_per_lap=ADV_LAP, device="cuda")
    frames = _Frames(ds, ADV_FRAMES)   # rendered on the card, set-up
    render_s = time.perf_counter() - t0
    with _RelocCalls("14a") as reloc14:
        a_launches, a = run_adversarial(base, frames, ADV_FRAMES, "a. adversarial, synchronous", kidnap=True)
    pipe_cfg = base.replace(tracking=dataclasses.replace(base.tracking, pipelined=True))
    b_launches, b = run_adversarial(pipe_cfg, frames, ADV_FRAMES, "b. adversarial, pipelined", kidnap=False)
    print(f"[14/22] a/b: {ADV_FRAMES} frames each ({render_s:.1f} s to render), keyframes "
          f"{a['keyframes_inserted']} / {b['keyframes_inserted']}, wall {a['wall_s']:.3f} / {b['wall_s']:.3f} s, "
          f"closures {a['closures']} / {b['closures']}, frame-level queries {a['frame_loop_queries']} / "
          f"{b['frame_loop_queries']}, weak-frame recoveries {a['weak_frame_recoveries']} / "
          f"{b['weak_frame_recoveries']}, ATE live {a['ate_live_m']:.4f} / {b['ate_live_m']:.4f} m final "
          f"{a['ate_final_m']:.4f} / {b['ate_final_m']:.4f} m on {a['path_len_m']:.2f} m, launches "
          f"{a_launches} / {b_launches}", flush=True)
    del frames
    with _GBACalls() as gba14c, _LoopCalls(keep=False) as loop14c:
        c_launches, c = run_scale(base)
    c["gba_calls"] = gba14c.summary()
    c["loop_calls"] = loop14c.summary()
    c["kidnap_ms"] = a["kidnap_ms"]
    print(f"[14/22] c: {c['frames']} frames, {c['keyframes_inserted']} keyframes, grows "
          f"{[(g['frame'], g['frm'], g['to']) for g in c['grow']]}, closures at {c['closure_calls']}, "
          f"{c['captures']} captures, {len(c['replay_vs_eager'])} replays bit-equal to eager, fps "
          f"{[p['fps'] for p in c['fps_curve']]}, map {c['final_map_mb']} MB, peak device memory "
          f"{c['peak_mem_mib']:.1f} MiB, {c['wall_s']:.1f} s, launches {c_launches}", flush=True)
    return [a_launches, b_launches, c_launches], c, reloc14.calls


def _k1_twin(canvas, table, threshold, nms=True, out=None):
    """K1's plain version over every map a ``PyramidTable`` places in the
    canvas, on the canvas's device (what the wrapper runs on a CPU canvas)."""
    imgs = canvas.reshape(table.batch, -1, canvas.shape[-1])
    maps = []
    for l, (hl, wl) in enumerate(table.level_shapes):
        r0 = int(table.segs[l * table.batch, 0])
        score = fast.fast_score(imgs[:, r0:r0 + hl, :wl], threshold)
        maps.append(fast.nms3(score) if nms else score)
    return maps


def _twins():
    """The extractor's K1 and K2 calls swapped for their plain twins."""
    from orb_slam2_ros2_tpu_torch.features import extractor as ext_mod

    return (_Spy(fast, "fast_score_nms_pyramid", replace=_k1_twin),
            _Spy(ext_mod, "extract_patches_48x64",
                 replace=lambda canvas, centers, out=None: patches.extract_patches_plain(canvas, centers)))


def _equal_trees(a, b) -> bool:
    from orb_slam2_ros2_tpu_torch.pipeline.frame_graph import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@contextlib.contextmanager
def debug_graphs():
    """CUDA graphs made in the ``with`` body keep their captured graph
    (``keep_graph``, instantiated as soon as the capture ends) with debugging
    on, so ``graph_kernel_nodes`` can read which kernels they hold."""
    made = torch.cuda.CUDAGraph

    class DebugGraph(made):
        def __init__(self, keep_graph=False):
            super().__init__(True)   # the binding's constructor
            self.enable_debug_mode()

        def capture_end(self):
            super().capture_end()
            self.instantiate()

    torch.cuda.CUDAGraph = DebugGraph
    try:
        yield
    finally:
        torch.cuda.CUDAGraph = made


def graph_kernel_nodes(graph) -> dict:
    """The nodes of a graph captured under ``debug_graphs`` that run K1, K2
    and K3 (by kernel), and its node count, read from its DOT dump
    (``cudaGraphDebugDotPrint``)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graph.dot")
        graph.debug_dump(path)
        with open(path) as f:
            dot = f.read()
    start = r'[ \t]*"[^"\n]*node[^"\n]*"\s*\['   # a node statement: "graph_1_node_0"[...]
    nodes = [c for c in re.split(r"\n(?=" + start + ")", dot) if re.match(start, c)]
    out = {name: sum(f"{name}_kernel" in n for n in nodes) for name in KERNELS}
    out["nodes"] = len(nodes)
    return out


def _sync_error():
    """``set_sync_debug_mode("error")`` for the ``with`` body: any host
    synchronisation inside raises."""

    @contextlib.contextmanager
    def guard():
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(prev)

    return guard()


def run_extractor_single(base: SLAMConfig):
    """15a: the one-image extractor on one rendered frame, with the kernels
    (the main path: K1 and K2 once) and with their plain twins, bit-equal;
    the FAST dispatchers against the plain score maps on that image."""
    from orb_slam2_ros2_tpu_torch.features import make_extractor
    from orb_slam2_ros2_tpu_torch.geometry.camera import CameraParams

    img = SyntheticStereoDataset(base.camera, n_frames=3, speed=SPEED, device="cuda").frame(1)[0]
    cam = CameraParams.from_config(base.camera, "cuda")
    ext = make_extractor(base, "cuda")
    torch.cuda.synchronize()
    _reset_launches()
    feats, pt = ext(img, cam)
    torch.cuda.synchronize()
    launches = _launches()
    if tuple(launches[k] for k in KERNELS) != (1, 1, 1):
        raise AssertionError(f"15a: one-image extractor launched {launches}")
    k1, k2 = _twins()
    with k1, k2:
        feats_p, pt_p = ext(img, cam)
    if (k1.calls, k2.calls) != (1, 1) or not _equal_trees((feats, pt), (feats_p, pt_p)):
        raise AssertionError(f"15a: extractor with kernels differs from its plain twins ({k1.calls}, {k2.calls})")
    x = img.to(torch.bfloat16)
    plain = fast.fast_score(x, FAST_TH)
    for name, got, want in (("fast_score_dispatch", fast.fast_score_dispatch(x, FAST_TH), plain),
                            ("fast_score_nms_dispatch", fast.fast_score_nms_dispatch(x, FAST_TH), fast.nms3(plain))):
        if not torch.equal(got, want):
            raise AssertionError(f"15a: {name} differs from its plain map in {int((got != want).sum())} pixels")
    out = dict(valid=int(feats.valid.sum()), capacity=feats.capacity, launches=launches)
    print(f"[15/22] a. one-image extractor: {json.dumps(out)}; bit-equal with the plain twins; "
          f"fast_score_dispatch and fast_score_nms_dispatch bit-equal to fast_score / nms3(fast_score) "
          f"on the {tuple(x.shape)} image", flush=True)
    return launches


def run_odometry(base: SLAMConfig):
    """15b: ``OdometryTracker`` over ODO_FRAMES frames of the KITTI-like
    forward world (every frame tracked, ATE under 5% of the path), then the
    fused step eagerly and from its CUDA graph in turns, bit-equal, with no
    host synchronisation; K1 and K2 once each among the graph's nodes, and
    one replay traced.  Returns the launch counts of
    the tracker's run and of the graph's."""
    from orb_slam2_ros2_tpu_torch.features import make_stereo_frontend
    from orb_slam2_ros2_tpu_torch.geometry.camera import CameraParams
    from orb_slam2_ros2_tpu_torch.pipeline import tracking as tr

    ds = SyntheticStereoDataset(base.camera, n_frames=ODO_FRAMES, speed=SPEED, device="cuda")
    frames = [ds.frame(i) for i in range(ODO_FRAMES)]   # rendered on the card, set-up
    gt = [g for _, _, g in frames]
    cam = CameraParams.from_config(base.camera, "cuda")
    fe = make_stereo_frontend(base, "cuda")
    tracker = tr.OdometryTracker(base, cam, device="cuda")
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    est, retries = [], 0
    for i, (l, r, _) in enumerate(frames):
        pose, info = tracker.track(fe(l, r, cam))
        if pose is None or tracker.state != TrackState.OK:
            raise AssertionError(f"15b: odometry frame {i}: {tracker.state} {info}")
        retries += bool(info.get("wide_retry"))
        est.append(np.linalg.inv(pose.astype(np.float64)))
    tracker_s = time.perf_counter() - t0
    tracker_launches = _launches()
    if tuple(tracker_launches[k] for k in KERNELS) != (ODO_FRAMES,) * len(KERNELS):
        raise AssertionError(f"15b: tracker launches {tracker_launches} for {ODO_FRAMES} frames")
    path = path_length(gt)
    ate = ate_rmse(est, gt)
    if not ate < MAX_ATE_LIVE * path:
        raise AssertionError(f"15b: odometry ATE {ate:.4f} m ≥ {MAX_ATE_LIVE} × {path:.2f} m")

    step = tr.make_fused_odometry_step(base, "cuda")
    eye = torch.eye(4, dtype=torch.float32, device="cuda")
    sf0 = fe(frames[0][0], frames[0][1], cam)
    pw, has = tr.unproject_frame(cam, sf0, eye)
    state_e = state_g = (tr.TrackedFrame(sf0, eye, pw, has), eye)
    eager_ms, replay_ms, wrapper = [], [], dict.fromkeys(KERNELS, 0)
    prof = trace = None
    for i in range(1, ODO_FRAMES):
        l, r, _ = frames[i]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _sync_error():
            out_e = step.program(cam, l, r, *state_e)
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t0) * 1000.0)
        before = _launches()
        t0 = time.perf_counter()
        if i == PROFILED_CALL:
            r0 = step.replays
            prof = kernel_profile(lambda: step(cam, l, r, *state_g))
            out_g = prof.pop("result")
            trace = dict(_kernel_counts(prof), graph_launches=prof["graph_launches"], replays=step.replays - r0)
            if (trace["graph_launches"], trace["replays"]) != (1, 1):
                raise AssertionError(f"15b: traced replay {trace}")
            _replays["profiled"] += 1
        else:
            with _sync_error(), (debug_graphs() if i == 1 else contextlib.nullcontext()):
                out_g = step(cam, l, r, *state_g)
            torch.cuda.synchronize()
            if i > 1:
                replay_ms.append((time.perf_counter() - t0) * 1000.0)
        for k in wrapper:
            wrapper[k] += _launches()[k] - before[k]
        if not _equal_trees(out_e, out_g):
            raise AssertionError(f"15b: fused step frame {i}: graph replay differs from the eager step")
        state_e, state_g = out_e[:2], out_g[:2]
    if step.captures != 1 or step.replays != ODO_FRAMES - 2 or wrapper != dict.fromkeys(KERNELS, 1):
        raise AssertionError(f"15b: {step.captures} captures, {step.replays} replays, wrapper launches {wrapper}")
    # what the graph holds, from its nodes: K1, K2 and K3 once each (a replay
    # runs every node once); the trace above is what the profiler recorded of one
    nodes = graph_kernel_nodes(next(iter(step._graphs.values())).graph)
    if tuple(nodes[k] for k in KERNELS) != (1, 1, 1):
        raise AssertionError(f"15b: the odometry graph's kernel nodes {nodes}")
    graph_launches = dict(wrapper, replays=step.replays)
    _replays["run"] += step.replays
    out = dict(frames=ODO_FRAMES, ate_m=ate, path_m=path, wide_retries=retries, tracker_s=tracker_s,
               tracker_launches=tracker_launches, eager_ms_median=statistics.median(eager_ms),
               replay_ms_median=statistics.median(replay_ms), captures=step.captures, replays=step.replays,
               replay_profile={k: prof[k] for k in ("launches", "graph_launches", "kernels", "kernel_ms")},
               graph_nodes=nodes, trace=trace,
               sync_debug="error: no host synchronisation in the eager steps or the replays")
    print(f"[15/22] b. odometry: {json.dumps(out)}; {ODO_FRAMES - 1} fused steps bit-equal eager / replay",
          flush=True)
    return tracker_launches, graph_launches


def sba_problem(cam_cfg, gen: torch.Generator):
    """A local-BA-sized grid problem on the card, from ``gen``: SBA_CAMS
    cameras 0.4 m apart moving forward (the first SBA_FIXED fixed) with
    SBA_SLOTS stereo slots each, over SBA_POINTS point slots.  Each of the
    first SBA_CAMS · SBA_SLOTS / SBA_VIEWS points is seen by SBA_VIEWS
    consecutive cameras (cyclically: point q by cameras q, q+1, … mod
    SBA_CAMS), so neighbouring cameras share points as a keyframe window
    does; it is placed 8-40 m ahead in the view of the most forward of
    them, so the others see it too.  The remaining slots are unobserved.
    0.3 px noise, SBA_OUTLIERS of the edges moved 15-40 px, free poses and
    the points perturbed.  Returns (problem, ground-truth poses, outlier
    mask)."""
    from orb_slam2_ros2_tpu_torch.geometry import se3
    from orb_slam2_ros2_tpu_torch.solvers.schur_ba import BAProblem

    dev = "cuda"
    C, N, P, V = SBA_CAMS, SBA_SLOTS, SBA_POINTS, SBA_VIEWS
    per_residue = N // V
    n_obs = C * per_residue                  # observed points

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    i = torch.arange(C, device=dev, dtype=torch.float32)[:, None]
    xi = torch.cat([torch.cat([0.02 * i, 0.01 * i, -0.4 * i], 1), 0.01 * randn(C, 3)], 1)
    Tcw = se3.exp(xi)
    q = torch.arange(n_obs, device=dev)
    front = Tcw[torch.clamp(q % C + V - 1, max=C - 1)]   # the most forward camera seeing q
    z = 8.0 + 32.0 * rand(n_obs)
    u = 40.0 + (cam_cfg.width - 80) * rand(n_obs)
    v = 30.0 + (cam_cfg.height - 60) * rand(n_obs)
    pc = torch.stack([(u - cam_cfg.cx) / cam_cfg.fx * z, (v - cam_cfg.cy) / cam_cfg.fy * z, z], 1)
    pts = torch.zeros(P, 3, device=dev)
    pts[:n_obs] = torch.einsum("qji,qj->qi", front[:, :3, :3], pc - front[:, :3, 3])
    # camera c's slot j·per_residue + m holds point ((c − j) mod C) + C·m
    c_ = torch.arange(C, device=dev)[:, None, None]
    j_ = torch.arange(V, device=dev)[None, :, None]
    m_ = torch.arange(per_residue, device=dev)[None, None, :]
    slot = ((c_ - j_) % C + C * m_).reshape(C, N).to(torch.int32)
    pc = torch.einsum("cij,cnj->cni", Tcw[:, :3, :3], pts[slot.long()]) + Tcw[:, None, :3, 3]
    uv = torch.stack([cam_cfg.fx * pc[..., 0] / pc[..., 2] + cam_cfg.cx,
                      cam_cfg.fy * pc[..., 1] / pc[..., 2] + cam_cfg.cy], -1) + 0.3 * randn(C, N, 2)
    valid = ((pc[..., 2] > 0.5) & (uv[..., 0] > 0) & (uv[..., 0] < cam_cfg.width)
             & (uv[..., 1] > 0) & (uv[..., 1] < cam_cfg.height))
    right_u = torch.where(valid, uv[..., 0] - cam_cfg.bf / pc[..., 2].clamp(min=0.5), -1.0)
    outlier = valid & (rand(C, N) < SBA_OUTLIERS)
    shift = (15.0 + 25.0 * rand(C, N, 2)) * torch.where(rand(C, N, 2) < 0.5, -1.0, 1.0)
    uv = torch.where(outlier[..., None], uv + shift, uv)
    free = torch.arange(C, device=dev) >= SBA_FIXED
    noise = torch.cat([0.05 * randn(C, 3), 0.01 * randn(C, 3)], 1)
    Tcw_init = torch.where(free[:, None, None], se3.exp(noise) @ Tcw, Tcw)
    prob = BAProblem(
        cam_Tcw=Tcw_init, cam_free=free, pt_pos=pts + 0.1 * randn(P, 3),
        pt_valid=torch.ones(P, dtype=torch.bool, device=dev), pt_slot=torch.where(valid, slot, -1),
        uv=uv, right_u=right_u, inv_sigma2=torch.ones(C, N, device=dev), edge_valid=valid,
    )
    return prob, Tcw, outlier


def _pose_diff(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(largest camera-centre distance in m, largest rotation angle in °)."""
    a, b = a.double().cpu(), b.double().cpu()
    dR = a[:, :3, :3] @ b[:, :3, :3].transpose(1, 2)
    w = torch.stack([dR[:, 2, 1] - dR[:, 1, 2], dR[:, 0, 2] - dR[:, 2, 0], dR[:, 1, 0] - dR[:, 0, 1]], 1)
    ang = torch.rad2deg(torch.asin((w.norm(dim=1) / 2).clamp(max=1.0)))
    ca = -torch.einsum("cji,cj->ci", a[:, :3, :3], a[:, :3, 3])
    cb = -torch.einsum("cji,cj->ci", b[:, :3, :3], b[:, :3, 3])
    return float((ca - cb).norm(dim=1).max()), float(ang.max())


def run_schur_ba(base: SLAMConfig, gen: torch.Generator) -> dict:
    """15c: ``solve_ba`` on a local-BA-sized grid problem: the error falls,
    the fixed cameras keep their bits, no host synchronisation, and the
    same call on a CPU copy agrees within the CPU tests' tolerances."""
    from orb_slam2_ros2_tpu_torch.geometry.camera import CameraParams
    from orb_slam2_ros2_tpu_torch.solvers import schur_ba

    prob, _, outlier = sba_problem(base.camera, gen)
    cam = CameraParams.from_config(base.camera, "cuda")
    schur_ba.solve_ba(cam, prob)   # warm-up (library handles, allocator)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    with _sync_error():
        T, pts, inl = schur_ba.solve_ba(cam, prob)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    peak_mib = (torch.cuda.max_memory_allocated() - mem0) / 2 ** 20
    # the robust cost the LM minimises, and the median χ² of the edges left
    # clean (a point seen twice, once by an outlier, may be dragged off)
    chi2_th = torch.where(prob.right_u > 0, 7.815, 5.991)
    rho = schur_ba._truncated_huber(chi2_th)
    chi_a, chi_b = (schur_ba._chi2(cam, prob, Tx, px) for Tx, px in ((prob.cam_Tcw, prob.pt_pos), (T, pts)))
    cost0, cost1 = float(rho(chi_a, prob.edge_valid)), float(rho(chi_b, prob.edge_valid))
    good = prob.edge_valid & ~outlier
    chi0, chi1 = float(chi_a[good].median()), float(chi_b[good].median())
    fixed_kept = torch.equal(T[:SBA_FIXED], prob.cam_Tcw[:SBA_FIXED])
    cpu = schur_ba.solve_ba(CameraParams.from_config(base.camera, "cpu"),
                            schur_ba.BAProblem(*(t.cpu() for t in prob)))
    d_m, d_deg = _pose_diff(T, cpu[0])
    # points that keep an inlier edge (one with every edge gated out is
    # held by nothing but Huber-weighted outliers; the reference culls it)
    slot = prob.pt_slot.clamp(min=0).long()
    kept = torch.zeros(SBA_POINTS, dtype=torch.bool, device="cuda")
    kept[slot[inl]] = True
    d_pts = float((pts.cpu() - cpu[1]).abs()[kept.cpu()].max())
    d_gate = int((inl.cpu() != cpu[2]).sum())
    out = dict(cameras=SBA_CAMS, fixed=SBA_FIXED, slots=SBA_SLOTS, point_slots=SBA_POINTS,
               points_observed=SBA_CAMS * SBA_SLOTS // SBA_VIEWS, views_per_point=SBA_VIEWS,
               edges=int(prob.edge_valid.sum()), outliers=int(outlier.sum()),
               outliers_gated=int((outlier & ~inl).sum()), robust_cost_before=cost0, robust_cost_after=cost1,
               chi2_clean_median_before=chi0, chi2_clean_median_after=chi1, ms=ms, peak_mem_mib=peak_mib, fixed_bit_unchanged=fixed_kept,
               cpu_pose_diff_m=d_m, cpu_rot_diff_deg=d_deg, points_with_an_inlier=int(kept.sum()),
               cpu_point_diff_m=d_pts, cpu_gate_diff=d_gate,
               sync_debug="error: no host synchronisation")
    print(f"[15/22] c. Schur BA: {json.dumps(out)}", flush=True)
    if not (cost1 < cost0 and chi1 < 0.1 * chi0):
        raise AssertionError(f"15c: robust cost {cost0:.1f} → {cost1:.1f}, clean edges' median χ² "
                             f"{chi0:.3f} → {chi1:.3f}")
    if not fixed_kept:
        raise AssertionError("15c: a fixed camera moved")
    if d_m > 1e-4 or d_deg > 1e-3 or d_pts > 1e-3 or d_gate:
        raise AssertionError(f"15c: the CPU copy differs: {d_m} m, {d_deg}°, points {d_pts} m, gates {d_gate}")
    return out


def run_corpus(base: SLAMConfig):
    """15d: ``train_corpus_vocab.main`` at the full image size on CORPUS_PAIRS
    frame pairs of each world with the depth cut to CORPUS_DEPTH (the
    packaged vocabulary is L = 5 over every pair: the cut keeps the phase
    short); its K1 launches over the four-image table and its extraction
    held to the plain twins on one batch."""
    from orb_slam2_ros2_tpu_torch import train_corpus_vocab as tcv

    with tempfile.TemporaryDirectory() as tmp:
        _reset_launches()
        stats = tcv.main(out=os.path.join(tmp, "vocab.npz"), device="cuda", depth=CORPUS_DEPTH, pairs=CORPUS_PAIRS, cfg=base)
        launches = _launches()
    n_batches = CORPUS_PAIRS * len(tcv.worlds(base.camera, "cuda"))
    if tuple(launches[k] for k in KERNELS) != (n_batches,) * len(KERNELS):
        raise AssertionError(f"15d: corpus launches {launches} for {n_batches} batches")

    extract = tcv.CorpusExtractor(base, "cuda")
    ds = tcv.worlds(base.camera, "cuda")[3][1]   # the adversarial world
    l0, r0, _ = ds.frame(0)
    l1, r1, _ = ds.frame(1)
    seen = []   # the canvas and table of the batch's K1 call
    with _Spy(fast, "fast_score_nms_pyramid", pred=lambda c, t, *a, **kw: not seen.append((c, t))) as k1:
        descs = extract(l0, l1, r0, r1)
    k1_twin, k2_twin = _twins()
    with k1_twin, k2_twin:
        descs_plain = extract(l0, l1, r0, r1)
    canvas, table = seen[0]
    maps = fast.fast_score_nms_pyramid(canvas, table, FAST_TH)
    twin = _k1_twin(canvas, table, FAST_TH)
    torch.cuda.synchronize()
    if table.batch != 4 or k1.calls != 1 or not all(torch.equal(a, b) for a, b in zip(maps, twin)):
        raise AssertionError(f"15d: K1 over the four-image table ({table.batch} images) differs from its twin")
    if not np.array_equal(descs, descs_plain):
        raise AssertionError("15d: corpus descriptors with the kernels differ from the plain twins'")
    print(f"[15/22] d. corpus (depth cut to {CORPUS_DEPTH}, {CORPUS_PAIRS} pairs a world): {json.dumps(stats)}; "
          f"K1 over the 4-image table ({table.n_tiles} tiles, {len(table.level_shapes)} levels × 4 "
          f"images) and the batch's descriptors bit-equal to the plain twins; launches {launches}", flush=True)
    return launches, stats


def run_profiled(map_cfg: SLAMConfig):
    """15e: the system's tracer (``SLAM.time_programs``) over phase 6's
    first PROFILE_FRAMES frames: each stage that ran is a host span of
    positive length (``frontend`` on the first frame, ``dispatch`` on each
    later one, ``map_front`` a keyframe, ``map_tail`` at least once), and
    each frame-graph replay and keyframe front a device span of positive
    length (call PROFILED_CALL is traced by the profiler, its spans with
    it)."""
    ds = SyntheticStereoDataset(map_cfg.camera, n_frames=MAP_FRAMES + 2, speed=MAP_SPEED,
                                box_scale=2.5, sky=True, device="cuda")
    frames = [ds.frame(i) for i in range(PROFILE_FRAMES)]   # rendered on the card, set-up
    slam = SLAM(map_cfg, enable_loop_closing=False, device="cuda")
    slam.time_programs = True
    torch.cuda.synchronize()
    _reset_launches()
    for i, (l, r, _) in enumerate(frames):
        pose, stats, _ = _track(slam, i, l, r, profile=i == PROFILED_CALL)
        if slam.state != TrackState.OK or pose is None:
            raise AssertionError(f"15e: frame {i}: {slam.state} {stats}")
    slam.flush()
    torch.cuda.synchronize()
    launches = _launches()
    trace = slam.trace_export()
    host, device = {}, {}
    for name, t0, t1, *_ in trace["host"]:
        host.setdefault(name, []).append((t1 - t0) / 1e6)
    for name, t0, t1 in trace["device"]:
        device.setdefault(name, []).append((t1 - t0) / 1e6)
    new_kf = slam._n_kf - 1
    counts = {k: len(v) for k, v in host.items()}
    replays = trace["counters"].get("replays.frame", 0)
    want = {"track": PROFILE_FRAMES, "frontend": 1, "dispatch": PROFILE_FRAMES - 1, "map_front": new_kf}
    if (any(counts.get(k) != n for k, n in want.items()) or not 1 <= counts.get("map_tail", 0) <= new_kf
            or not 1 <= replays == len(device.get("frame_graph", ())) or len(device.get("map_front", ())) != new_kf
            or not all(t > 0 for ms in (*host.values(), *device.values()) for t in ms)):
        raise AssertionError(f"15e: host spans {counts}, device spans "
                             f"{ {k: len(v) for k, v in device.items()} }, {replays} frame replays, for {new_kf} "
                             f"keyframes after keyframe 0")
    summary = {f"{side}:{k}": dict(n=len(v), median_ms=statistics.median(v), max_ms=max(v))
               for side, spans in (("host", host), ("device", device)) for k, v in spans.items()}
    print(f"[15/22] e. tracer over {PROFILE_FRAMES} frames ({new_kf} keyframes after keyframe 0): "
          f"{json.dumps(summary)}, launches {launches}", flush=True)
    return launches, summary


def run_remaining(base: SLAMConfig, map_cfg: SLAMConfig, gen: torch.Generator) -> list:
    """Phase 15: the one-image extractor, the odometry path, the per-camera
    Schur BA, the corpus trainer and stage profiling.  Returns the launch
    counts of the main-path runs."""
    t0 = time.perf_counter()
    a = run_extractor_single(base)
    b_tracker, b_graph = run_odometry(base)
    run_schur_ba(base, gen)
    d, _ = run_corpus(base)
    e, _ = run_profiled(map_cfg)
    print(f"[15/22] done in {time.perf_counter() - t0:.1f} s", flush=True)
    return [a, b_tracker, b_graph, d, e]


# ------------------------------------------------ keyframe and closure graphs --

def _kf_key(name: str, args) -> tuple:
    """A keyframe program's graph: the tail's is per (do_ba, do_cull)."""
    return (name, *args[-2:]) if name == "map_tail" else (name,)


def run_keyframe_graphs(map_cfg: SLAMConfig):
    """16a: phase 6's mapping world, every keyframe program that fires
    checked as it runs: first eagerly on a clone of the map storage (the
    program before the graphs, its CUDA-event span), then through the SLAM's
    ``KeyframeGraphs`` (a capture at its first call, a replay after) under
    the SLAM's sync debug "error"; the storage and the outputs must equal
    the eager program's bit for bit.  The first replay of each program is
    traced: one graph launch, and no kernel launched by the host beyond the
    copies of its inputs, the id fills and the clones of its outputs.
    Returns (launch counts of the run, summary)."""
    from orb_slam2_ros2_tpu_torch.mapstate.map_state import MapState
    from orb_slam2_ros2_tpu_torch.pipeline.frame_graph import tree_leaves

    ds = SyntheticStereoDataset(map_cfg.camera, n_frames=MAP_FRAMES + 2, speed=MAP_SPEED,
                                box_scale=2.5, sky=True, device="cuda")
    frames = [ds.frame(i) for i in range(MAP_FRAMES)]   # rendered on the card, set-up
    slam = SLAM(map_cfg, enable_loop_closing=False, device="cuda")
    g = slam._kf_graphs
    eager_programs = {
        "map_front": lambda m, *a: slam.map_front_program(m, *a),
        "map_tail": lambda m, *a: slam.map_tail_program(m, *a),
        "cull_kfs": lambda m, *a: (slam._cull_kfs(m, *a),),
    }
    calls, bad, traced = [], [], set()

    def checked(name):
        graph_fn, eager_fn = getattr(g, name), eager_programs[name]

        def call(mapstate, *args):
            key = _kf_key(name, args)
            mode = torch.cuda.get_sync_debug_mode()   # the SLAM's "error"
            torch.cuda.set_sync_debug_mode(0)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            clone = MapState(*(t.clone() for t in mapstate))
            trace = (key not in traced and any(c["key"] == key for c in calls)
                     and not torch.autograd._profiler_enabled())
            prof = eager_prof = None
            ev[0].record()
            if trace:   # the eager program's kernels and launches, beside the replay's
                eager_prof = kernel_profile(lambda: eager_fn(clone, *args))
                want_map, *want_out = eager_prof.pop("result")
            else:
                want_map, *want_out = eager_fn(clone, *args)
            ev[1].record()
            torch.cuda.synchronize()
            caps0, replays0 = g.captures, g.replays
            t0 = time.perf_counter()
            ev[2].record()
            if trace:
                traced.add(key)
                prof = kernel_profile(lambda: graph_fn(mapstate, *args))
                out = prof.pop("result")
            else:
                torch.cuda.set_sync_debug_mode(mode)
                out = graph_fn(mapstate, *args)
                torch.cuda.set_sync_debug_mode(0)
            ev[3].record()
            host_ms = (time.perf_counter() - t0) * 1000.0
            torch.cuda.synchronize()
            rec = dict(key=key, captured=g.captures > caps0, replayed=g.replays > replays0,
                       eager_ms=ev[0].elapsed_time(ev[1]), graph_ms=ev[2].elapsed_time(ev[3]), host_ms=host_ms)
            fields = [n for n, a, b in zip(MapState._fields, mapstate, want_map) if not torch.equal(a, b)]
            if fields or not _equal_trees(out, want_out if name != "map_tail" else want_out[0]):
                bad.append(f"{key} call {len(calls)}: the graph differs from eager (map fields {fields})")
            if prof is not None:
                bound = len(tree_leaves(args)) + len(tree_leaves(out)) + 2
                keys = ("graph_launches", "launches", "device_kernels", "kernel_ms", "wall_ms")
                rec["profile"] = {k: prof[k] for k in keys}
                rec["eager_profile"] = {k: eager_prof[k] for k in keys}
                if prof["graph_launches"] != 1 or prof["launches"] > bound:
                    bad.append(f"{key} traced replay: {prof['graph_launches']} graph launches, "
                               f"{prof['launches']} host kernel launches (inputs and outputs: {bound})")
            calls.append(rec)
            torch.cuda.set_sync_debug_mode(mode)
            return out

        return call

    for name in eager_programs:
        setattr(g, name, checked(name))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    peak0, reserved0 = torch.cuda.max_memory_allocated(), torch.cuda.memory_reserved()
    _reset_launches()
    records = []
    for i, (img_l, img_r, _) in enumerate(frames):
        slam.frame_sync_debug_mode = "error" if i >= 2 else None
        pose, stats, ms = _track(slam, f"16a {i}", img_l, img_r, profile=i == PROFILED_CALL)
        if slam.state != TrackState.OK or pose is None:
            raise AssertionError(f"16a frame {i}: state {slam.state}, stats {stats}")
        records.append(dict(ms=ms, profiled=i == PROFILED_CALL))
    slam.flush()
    torch.cuda.synchronize()
    slam.frame_sync_debug_mode = None
    launches = _launches()
    peak = torch.cuda.max_memory_allocated() - peak0
    torch.cuda.empty_cache()   # what stays reserved: the graphs' pools and statics
    held = torch.cuda.memory_reserved() - reserved0
    by_key: dict = {}
    for c in calls:
        by_key.setdefault(" ".join(map(str, c["key"])), []).append(c)
    summary = {}
    for k, cs in by_key.items():
        cap = [c for c in cs if c["captured"]]
        rep = [c for c in cs if c["replayed"] and "profile" not in c]
        summary[k] = dict(
            calls=len(cs), captures=len(cap), capture_ms=[round(c["host_ms"], 3) for c in cap],
            eager_span_ms_median=statistics.median(c["eager_ms"] for c in cs if "profile" not in c),
            replay_span_ms_median=statistics.median(c["graph_ms"] for c in rep) if rep else None,
            replay_host_ms_median=statistics.median(c["host_ms"] for c in rep) if rep else None,
            traced=[dict(replay=c["profile"], eager=c["eager_profile"]) for c in cs if "profile" in c])
        if not rep or not summary[k]["traced"] or len(cap) != 1:
            bad.append(f"{k}: {len(cap)} captures, {len(rep)} untraced replays, "
                       f"{len(summary[k]['traced'])} traced")
    out = dict(frames=MAP_FRAMES, keyframes=slam._n_kf, programs=summary, graph_captures=g.captures,
               graph_replays=g.replays, map_copy_bytes=slam.map_copy_bytes,
               peak_mem_mib_above_start=peak / 2 ** 20, held_by_graphs_mib=held / 2 ** 20,
               frame_ms_median=_frame_ms(records))
    print(f"[16/22] a. keyframe programs: {json.dumps(out)}, launches {launches}", flush=True)
    if bad:
        raise AssertionError(f"16a: {bad}")
    return launches, out


class _EssentialCalls:
    """While active, every ``EssentialGraph`` call keeps its host ms and
    whether it captured; the last one also its inputs, cloned, and its
    graph's mesh (the closure phases 16b and 19b replay)."""

    def __enter__(self):
        from orb_slam2_ros2_tpu_torch.mapstate.map_state import MapState
        from orb_slam2_ros2_tpu_torch.pipeline import loop_closing
        from orb_slam2_ros2_tpu_torch.pipeline.frame_graph import tree_map

        self.cls, self.calls, self.inputs, self.mesh = loop_closing.EssentialGraph, [], None, None
        orig = self.orig = self.cls.__call__

        def spy(graph, state, *args):
            self.inputs = (MapState(*(t.clone() for t in state)), *tree_map(torch.clone, args))
            self.mesh = graph.mesh
            caps, t0 = graph.captures, time.perf_counter()
            out = orig(graph, state, *args)
            self.calls.append(dict(host_ms=(time.perf_counter() - t0) * 1000.0, captured=graph.captures > caps))
            return out

        self.cls.__call__ = spy
        return self

    def __exit__(self, *exc):
        self.cls.__call__ = self.orig


def run_essential_graph(base: SLAMConfig, spied: _EssentialCalls, loop: dict, tag: str = "16/22] b"):
    """16b: the essential graph of phase 9's closure, on the inputs its
    ``correct`` gave it: the eager program (``optimize_essential``) against
    a fresh ``EssentialGraph`` — its first call (eager run and the captures
    of its three parts, each part's ms), replays bit-equal to eager, one
    under sync debug "error", one traced (a graph launch for the problem,
    each GN step and the commit; no kernel launched by the host beyond
    copies and clones).  19b: the same for phase 13b's closure over the
    graph's mesh (``spied.mesh``; the eager program is ``_essential_mesh``'s),
    and a second closure (another pair and Sim3) through the fresh graph
    and through the same wrappers run eagerly.  Returns the summary."""
    from functools import partial

    from orb_slam2_ros2_tpu_torch.geometry.sim3 import Sim3
    from orb_slam2_ros2_tpu_torch.pipeline.loop_closing import EssentialGraph, optimize_essential
    from orb_slam2_ros2_tpu_torch.solvers.pose_graph import optimize_pose_graph

    state, kf_cur, kf_cand, S12, S_nc, gmask, pre = spied.inputs
    weight, mesh = base.loop.essential_graph_weight, spied.mesh
    mesh_kw = {} if mesh is None else dict(mesh=mesh, mesh_axis=mesh.axis)

    def eager_program(cur, cand, S):
        return optimize_essential(state, cur, cand, S, S_nc, gmask, pre, essential_weight=weight,
                                  pose_graph_fn=partial(optimize_pose_graph, iters=ESSENTIAL_ITERS, **mesh_kw))

    def timed(fn):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        out = fn()
        ev[1].record()
        torch.cuda.synchronize()
        return out, ev[0].elapsed_time(ev[1]), (time.perf_counter() - t0) * 1000.0

    want, eager_span, eager_host = timed(lambda: eager_program(kf_cur, kf_cand, S12))
    g = EssentialGraph(essential_weight=weight, mesh=mesh)
    part_ms = []
    for name, part in zip(("problem", "gn_step", "commit"), g.parts):
        first = part._first

        def timed_first(*a, _first=first, _name=name, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _first(*a, **kw)
            torch.cuda.synchronize()
            part_ms.append((_name, (time.perf_counter() - t0) * 1000.0))
            return out

        part._first = timed_first
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()

    def run():
        return g(state, kf_cur, kf_cand, S12, S_nc, gmask, pre)

    first, first_span, first_host = timed(run)
    torch.cuda.empty_cache()   # what stays reserved: the three graphs' pools, statics and the output
    held = torch.cuda.memory_reserved() - reserved0
    spans, hosts, bad = [], [], []
    outs = [first]
    for i in range(3):
        if i == 1:
            with _sync_error():
                out = run()
            torch.cuda.synchronize()
        else:
            out, span, host = timed(run)
            spans.append(span)
            hosts.append(host)
        outs.append(out)
    for i, out in enumerate(outs):
        for f in ("kf_Tcw", "mp_pos"):
            if not torch.equal(getattr(out, f), getattr(want, f)):
                bad.append(f"call {i}: {f} differs from the eager program")
    prof = kernel_profile(run)
    if not torch.equal(prof.pop("result").kf_Tcw, want.kf_Tcw):
        bad.append("the traced replay differs from the eager program")
    if prof["graph_launches"] != ESSENTIAL_ITERS + 2 or prof["launches"] > 200:
        bad.append(f"traced call: {prof['graph_launches']} graph launches, {prof['launches']} host kernel launches")
    extra, src = {}, "phase9" if mesh is None else "phase13b"
    if mesh is not None:
        # a second closure (another pair and Sim3) through the graph and
        # through the same wrappers run eagerly (the first closure's eager
        # program is ``_essential_mesh``'s; the CPU tests hold the wrappers
        # to it bit for bit)
        wrappers = EssentialGraph(essential_weight=weight, mesh=mesh, capture=False)
        cur2, cand2 = int(kf_cur) - 1, int(kf_cand) + 1
        S12b = Sim3(R=S12.R, t=S12.t + 0.05, s=S12.s * 1.01)
        got2, second_span, _ = timed(lambda: g(state, cur2, cand2, S12b, S_nc, gmask, pre))
        want2, wrapper_span, _ = timed(lambda: wrappers(state, cur2, cand2, S12b, S_nc, gmask, pre))
        for f in ("kf_Tcw", "mp_pos"):
            if not torch.equal(getattr(got2, f), getattr(want2, f)):
                bad.append(f"second closure: {f} differs from the eager wrappers' run")
        if torch.equal(got2.kf_Tcw, first.kf_Tcw):
            bad.append("the second closure gave the first one's poses")
        extra = dict(shards=mesh.size, second_closure=dict(
            pair=[cur2, cand2], replay_span_ms=second_span, eager_wrappers_span_ms=wrapper_span,
            max_abs_diff_vs_first=float((got2.kf_Tcw - first.kf_Tcw).abs().max())))
    summary = dict(
        kf_capacity=state.kf_capacity, route="mesh" if mesh is not None else
        "dense" if state.kf_capacity <= 256 else "pcg", **extra,
        **{f"{src}_optimize_essential_ms": loop["span_ms"].get("optimize_essential"),
           f"{src}_essential_calls": spied.calls},
        **({"eager_essential_s_before": EAGER_ESSENTIAL_S} if mesh is None else
           {"eager_mesh_route_ms_before": EAGER_MESH_SPAN_MS["optimize_essential"]}),
        eager_span_ms=eager_span, eager_host_ms=eager_host,
        first_call_ms=first_host, capture_ms_by_part=part_ms,
        held_by_graphs_mib=held / 2 ** 20,
        replay_span_ms=spans, replay_host_ms=hosts, captures=g.captures, replays=g.replays,
        traced={k: prof[k] for k in ("graph_launches", "launches", "device_kernels", "kernel_ms", "wall_ms",
                                     "api")})
    print(f"[{tag}. essential graph: {json.dumps(summary)}", flush=True)
    if bad:
        raise AssertionError(f"{tag}: {bad}")
    return summary


def run_graph_phase(map_cfg: SLAMConfig, base: SLAMConfig, spied: _EssentialCalls, loop: dict,
                    scale: dict) -> list:
    """Phase 16: the keyframe programs (a) and the essential graph (b) as
    CUDA graphs against their eager programs, and (c) the scale run of
    phase 14c beside the eager programs' (``EAGER_SCALE``).  Returns the
    launch counts of (a)."""
    t0 = time.perf_counter()
    a_launches, _ = run_keyframe_graphs(map_cfg)
    run_essential_graph(base, spied, loop)
    spans = {k: scale["keyframe_span_ms"].get(k) for k in ("map_front", "map_tail", "correct", "optimize_essential")}
    print(f"[16/22] c. scale run: {scale['frames']} frames in {scale['wall_s']:.3f} s, fps "
          f"{[p['fps'] for p in scale['fps_curve']]}, spans {json.dumps(spans)} | eager keyframe programs "
          f"and essential graph (commit 11141c4): {EAGER_SCALE['wall_s']} s, fps {EAGER_SCALE['fps']}",
          flush=True)
    print(f"[16/22] done in {time.perf_counter() - t0:.1f} s", flush=True)
    return [a_launches]


class _GBACalls:
    """While active, every ``GBAGraphs`` chunk and commit keeps its host ms,
    a CUDA-event pair around it (read after the run) and whether it
    captured; the chunks of the newest snapshot (with their mesh) and the
    newest commit also keep their inputs, cloned (the closures phases 17a
    and 19a run again)."""

    def __enter__(self):
        from orb_slam2_ros2_tpu_torch.mapstate.map_state import MapState
        from orb_slam2_ros2_tpu_torch.pipeline.frame_graph import tree_map
        from orb_slam2_ros2_tpu_torch.solvers.global_ba import GBAGraphs

        self.cls, self.calls, self.chunks, self.commit_in = GBAGraphs, [], [], None
        self._source = self._prob = None
        step, commit = self.orig = GBAGraphs.step, GBAGraphs.commit

        def iterate(pending):
            return pending._replace(Tcw=pending.Tcw.clone(), ptsT=pending.ptsT.clone(),
                                    pt_in_ba=pending.pt_in_ba.clone())

        def timed(kind, graphs, fn):
            caps = graphs.captures
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            t0 = time.perf_counter()
            ev[0].record()
            out = fn()
            ev[1].record()
            self.calls.append(dict(kind=kind, host_ms=(time.perf_counter() - t0) * 1000.0, events=ev,
                                   captured=graphs.captures > caps))
            return out

        def spy_step(graphs, pending, cam, *, robust_after, capacity, mesh=None):
            if pending.prob is not self._source:   # a new snapshot
                self._source, self._prob, self.chunks = pending.prob, tree_map(torch.clone, pending.prob), []
            self.chunks.append((iterate(pending)._replace(prob=self._prob), cam, robust_after, capacity, mesh))
            return timed("chunk", graphs, lambda: step(graphs, pending, cam, robust_after=robust_after,
                                                       capacity=capacity, mesh=mesh))

        def spy_commit(graphs, storage, pending, *, propagate_depth=None):
            self.commit_in = (MapState(*(t.clone() for t in storage)), iterate(pending), propagate_depth)
            return timed("commit", graphs, lambda: commit(graphs, storage, pending, propagate_depth=propagate_depth))

        GBAGraphs.step, GBAGraphs.commit = spy_step, spy_commit
        return self

    def __exit__(self, *exc):
        self.cls.step, self.cls.commit = self.orig

    def summary(self) -> dict:
        """Captures with their host ms, and replay spans, by kind (after a
        synchronise)."""
        torch.cuda.synchronize()
        out = {}
        for kind in ("chunk", "commit"):
            cs = [c for c in self.calls if c["kind"] == kind]
            rep = [c["events"][0].elapsed_time(c["events"][1]) for c in cs if not c["captured"]]
            out[kind] = dict(calls=len(cs), captures=sum(c["captured"] for c in cs),
                             capture_host_ms=[round(c["host_ms"], 1) for c in cs if c["captured"]],
                             replay_span_ms_median=statistics.median(rep) if rep else None,
                             replay_span_ms_max=max(rep) if rep else None)
        return out


def _timed_call(fn):
    """(fn(), its CUDA-event span ms, its host ms), synchronised around."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev[0].record()
    out = fn()
    ev[1].record()
    torch.cuda.synchronize()
    return out, ev[0].elapsed_time(ev[1]), (time.perf_counter() - t0) * 1000.0


def _held_mib(reserved0: int) -> float:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return (torch.cuda.memory_reserved() - reserved0) / 2 ** 20


def run_gba_graph(base: SLAMConfig, spied: _GBACalls, tag: str = "17/22] a") -> dict:
    """17a: phase 9's closure (the chunks of its snapshot and its commit,
    kept by ``_GBACalls``) through a fresh ``GBAGraphs`` and through the
    same static-buffer wrappers run eagerly (``capture=False``): every chunk
    (ungated and gated, one graph) and the commit bit-equal, a chunk under
    sync debug "error", one chunk replay traced (1 graph launch, a handful
    of host launches) beside the trace of the unbucketed eager chunk
    (``step_global_ba``, the program before this graph); printed: chunk ms
    each way, the first call's ms (eager run + capture), the memory the
    graphs hold, and phase 9's own captures and replay spans.  19a: the
    same for phase 13b's closure over the mesh its chunks ran on (the
    unbucketed eager chunk is ``step_global_ba`` over the mesh), and a
    second snapshot of the bucket (its poses and points moved) through
    both wrappers, against its own eager run."""
    from orb_slam2_ros2_tpu_torch.mapstate.map_state import MapState
    from orb_slam2_ros2_tpu_torch.solvers.global_ba import GBAGraphs, commit_global_ba, step_global_ba

    b = base.ba
    kw = dict(n_iters=1, pcg_iters=b.pcg_iters, chi2_mono=b.chi2_mono, chi2_stereo=b.chi2_stereo)
    chunks, n_chunks = spied.chunks, sum(base.loop.global_ba_phase_iters)
    if len(chunks) != n_chunks or spied.commit_in is None:
        raise AssertionError(f"{tag}: the run kept {len(chunks)} chunks of its closure's snapshot "
                             f"(want {n_chunks}) and {'a' if spied.commit_in else 'no'} commit")
    mesh = chunks[0][4]
    plain_kw = dict(kw, **({} if mesh is None else dict(mesh=mesh, axis=mesh.axis)))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    eager, graph = GBAGraphs(capture=False, **kw), GBAGraphs(**kw)

    def step(g, c):
        pend, cam, robust_after, capacity, mesh = c
        return g.step(pend, cam, robust_after=robust_after, capacity=capacity, mesh=mesh)

    first, first_span, first_host = _timed_call(lambda: step(graph, chunks[0]))
    held = _held_mib(reserved0)
    bad, rows = [], []
    for i, c in enumerate(chunks):
        want, e_span, e_host = _timed_call(lambda: step(eager, c))
        got, g_span, g_host = _timed_call(lambda: step(graph, c))
        pend, cam, robust_after = c[:3]
        # the unbucketed eager chunk: every chunk's without a mesh, the
        # first one's over a mesh (each costs ~0.4 s there)
        plain, p_span, _ = (_timed_call(lambda: step_global_ba(pend, cam, robust_after=robust_after, **plain_kw))
                            if mesh is None or i == 0 else (None, None, None))
        outs = [got] + ([first] if i == 0 else [])
        if not all(torch.equal(o.Tcw, want.Tcw) and torch.equal(o.ptsT, want.ptsT) for o in outs):
            bad.append(f"chunk {i}: the replay differs from the eager wrapper")
        rows.append(dict(chunk=i, gated=pend.chunks_done >= robust_after, eager_span_ms=e_span,
                         replay_span_ms=g_span, replay_host_ms=g_host, unbucketed_eager_span_ms=p_span,
                         unbucketed_max_abs_diff=None if plain is None else
                         [float((plain.Tcw - want.Tcw).abs().max()), float((plain.ptsT - want.ptsT).abs().max())]))
    with _sync_error():
        step(graph, chunks[-1])
    torch.cuda.synchronize()
    prof = kernel_profile(lambda: step(graph, chunks[-1]))
    prof.pop("result")
    pend, cam, robust_after = chunks[-1][:3]
    eprof = kernel_profile(lambda: step_global_ba(pend, cam, robust_after=robust_after, **plain_kw))
    eprof.pop("result")
    if prof["graph_launches"] != 1 or prof["launches"] > GBA_HOST_LAUNCHES:
        bad.append(f"traced chunk: {prof['graph_launches']} graph launches, {prof['launches']} host kernel "
                   f"launches (at most {GBA_HOST_LAUNCHES}: pads, copies in, the gate, clones out)")
    if graph.captures != 1 or graph.snapshot_loads != 1:
        bad.append(f"{graph.captures} chunk captures, {graph.snapshot_loads} snapshot loads (want 1 and 1)")
    second = None
    if mesh is not None:
        # a second snapshot of the bucket: its poses and points moved
        prob = pend.prob
        Tcw2 = prob.cam_Tcw.clone()
        Tcw2[1:, :3, 3] += 0.02
        moved = pend._replace(prob=prob._replace(cam_Tcw=Tcw2, pt_pos=prob.pt_pos + 0.01), Tcw=Tcw2,
                              ptsT=pend.ptsT + 0.01)
        c2 = (moved, *chunks[-1][1:])
        want2 = step(eager, c2)
        got2, span2, _ = _timed_call(lambda: step(graph, c2))
        if not (torch.equal(got2.Tcw, want2.Tcw) and torch.equal(got2.ptsT, want2.ptsT)):
            bad.append("second snapshot: the replay differs from its own eager run")
        last = step(eager, chunks[-1])
        if torch.equal(got2.Tcw, last.Tcw):
            bad.append("second snapshot: the replay gave the first snapshot's poses")
        if graph.captures != 1 or graph.snapshot_loads != 2:
            bad.append(f"second snapshot: {graph.captures} captures, {graph.snapshot_loads} snapshot loads")
        second = dict(replay_span_ms=span2, max_abs_diff_vs_first=float((got2.Tcw - last.Tcw).abs().max()))

    state, pend, depth = spied.commit_in
    into_eager, into_graph = (MapState(*(t.clone() for t in state)) for _ in range(2))
    _, ce_span, _ = _timed_call(lambda: eager.commit(into_eager, pend, propagate_depth=depth))
    _, c_first_span, c_first_host = _timed_call(lambda: graph.commit(into_graph, pend, propagate_depth=depth))
    torch._foreach_copy_(list(into_graph), list(state))   # the pre-commit map again, at the same addresses
    _, c_span, c_host = _timed_call(lambda: graph.commit(into_graph, pend, propagate_depth=depth))
    plain_commit = commit_global_ba(state, pend, propagate_depth=depth)
    fields = [n for n, a, g, p in zip(MapState._fields, into_eager, into_graph, plain_commit)
              if not (torch.equal(a, g) and torch.equal(a, p))]
    if fields:
        bad.append(f"commit: fields {fields} differ (eager wrapper, replay, commit_global_ba)")
    summary = dict(
        bucket=list(graph._bucket.key[:4]), snapshot=[int(chunks[0][0].Tcw.shape[0]),
                                                      int(chunks[0][0].ptsT.shape[1]),
                                                      int(chunks[0][0].prob.cm_pt.shape[0])],
        first_call_span_ms=first_span, first_call_host_ms=first_host, held_by_graphs_mib=held,
        chunks=rows, commit=dict(eager_span_ms=ce_span, first_call_span_ms=c_first_span,
                                 first_call_host_ms=c_first_host, replay_span_ms=c_span, replay_host_ms=c_host,
                                 rounds=graph.capture_log[-1][1]),
        traced_replay={k: prof[k] for k in ("graph_launches", "launches", "device_kernels", "kernel_ms",
                                            "wall_ms", "api")},
        traced_unbucketed_eager={k: eprof[k] for k in ("launches", "device_kernels", "kernel_ms", "wall_ms")},
        **({"phase9": spied.summary(), "eager_chunk_ms_before": EAGER_GBA_CHUNK_MS} if mesh is None else
           {"shards": mesh.size, "second_snapshot": second, "phase13b": spied.summary(),
            "eager_mesh_chunk_ms_before": EAGER_MESH_SPAN_MS["gba_chunk"]}))
    print(f"[{tag}. {'sharded ' if mesh else ''}GBA chunk and commit: {json.dumps(summary)}", flush=True)
    if bad:
        raise AssertionError(f"{tag}: {bad}")
    return summary


class _RelocCalls:
    """While active, every ``SLAM._relocalize`` that has a database keeps its
    inputs, cloned — the frame on the map's device, the frame id, the
    keyframe database, the map storage — with the vocabulary, the
    configuration and the phase's ``tag``, its host ms (to the fetch of its
    result), whether the relocalization graph captured or replayed, and the
    pose it returned."""

    def __init__(self, tag: str):
        self.tag = tag

    def __enter__(self):
        from orb_slam2_ros2_tpu_torch.mapstate.map_state import MapState
        from orb_slam2_ros2_tpu_torch.pipeline.frame_graph import tree_map

        self.calls = []
        orig = self.orig = SLAM._relocalize

        def spy(slam, frame, fid):
            if slam.loop_closer is None:
                return orig(slam, frame, fid)
            g = slam._reloc_graph
            caps, replays = g.captures, g.replays
            rec = dict(tag=self.tag, cfg=slam.cfg, fid=fid, frame=tree_map(torch.clone, slam._to_map(frame)),
                       db=tree_map(torch.clone, slam.loop_closer.db), map=MapState(*(t.clone() for t in slam.map)),
                       vocab=slam.loop_closer.vocab)
            t0 = time.perf_counter()
            pose, info = orig(slam, frame, fid)
            rec.update(host_ms=(time.perf_counter() - t0) * 1000.0, captured=g.captures > caps,
                       replayed=g.replays > replays, pose=pose, relocalized=bool(info.get("relocalized")))
            self.calls.append(rec)
            return pose, info

        SLAM._relocalize = spy
        return self

    def __exit__(self, *exc):
        SLAM._relocalize = self.orig


def run_reloc_graph(spied: list, frame_ms: dict) -> dict:
    """17b: the relocalizations of phases 7 and 14a (their inputs kept by
    ``_RelocCalls``; ``frame_ms`` their frames' ms by phase) through a fresh
    ``RelocGraph`` per configuration and through the same static-buffer
    wrapper run eagerly: every replay bit-equal to the eager run and to the
    pose the phase's own replay returned; one call eagerly and replayed
    under sync debug "error"; one replay traced (1 graph launch) beside the
    eager program's trace.  Every phase-7 and 14a relocalization must have
    replayed the graph the warm-up captured.  Returns the summary."""
    from orb_slam2_ros2_tpu_torch.mapstate.map_state import MapState
    from orb_slam2_ros2_tpu_torch.pipeline.frame_graph import RelocGraph
    from orb_slam2_ros2_tpu_torch.pipeline.system import RELOC_CANDIDATES
    from orb_slam2_ros2_tpu_torch.solvers.epnp import uniform_draw

    bad = [f"phase {c['tag']} fid {c['fid']}: captured, or did not replay"
           for c in spied if c["captured"] or not c["replayed"]]
    groups: dict = {}
    for c in spied:
        groups.setdefault((c["tag"], tuple(tuple(t.shape) for t in c["map"])), []).append(c)
    out, eager_ms, replay_ms, replay_host = [], [], [], []
    traced = sync_checked = False
    for calls in groups.values():
        slam = SLAM(calls[0]["cfg"], device="cuda")   # the program's constants
        store = MapState(*(t.clone() for t in calls[0]["map"]))
        eager = RelocGraph(slam.reloc_program, capture=False)
        graph = RelocGraph(slam.reloc_program)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved()
        first_host = held = None
        for i, c in enumerate(calls):
            torch._foreach_copy_(list(store), list(c["map"]))
            gen = torch.Generator(device="cuda")
            gen.manual_seed(c["fid"])
            u = uniform_draw((RELOC_CANDIDATES,), c["frame"].feats.capacity, gen)
            args = (c["frame"], u, c["db"], store, c["vocab"])
            if first_host is None:
                _, _, first_host = _timed_call(lambda: graph(*args))   # eager run + capture
                held = _held_mib(reserved0)
            want, e_span, _ = _timed_call(lambda: eager(*args))
            got, g_span, g_host = _timed_call(lambda: graph(*args))
            eager_ms.append(e_span)
            replay_ms.append(g_span)
            replay_host.append(g_host)
            if not _equal_trees(got, want):
                bad.append(f"fid {c['fid']}: the replay differs from the eager run")
            packed = got[0].cpu().numpy()
            acc = packed[:, 0] > 0
            live = (packed[int(np.argmax(acc)), 3:].reshape(4, 4) if acc.any() else None)
            if (live is None) != (c["pose"] is None) or (live is not None and not np.array_equal(live, c["pose"])):
                bad.append(f"fid {c['fid']}: the phase's relocalization returned another pose")
            if not sync_checked and c["relocalized"]:
                with _sync_error():
                    eager(*args)
                    graph(*args)
                torch.cuda.synchronize()
                sync_checked = True
            if not traced and c["relocalized"]:
                prof = kernel_profile(lambda: graph(*args))
                eprof = kernel_profile(lambda: eager(*args))
                if not _equal_trees(prof.pop("result"), eprof.pop("result")):
                    bad.append("the traced replay differs from the traced eager run")
                if prof["graph_launches"] != 1 or prof["launches"] > RELOC_HOST_LAUNCHES:
                    bad.append(f"traced replay: {prof['graph_launches']} graph launches, {prof['launches']} "
                               f"host kernel launches (at most {RELOC_HOST_LAUNCHES})")
                traced = dict(replay={k: prof[k] for k in ("graph_launches", "launches", "device_kernels",
                                                           "kernel_ms", "wall_ms", "api")},
                              eager={k: eprof[k] for k in ("launches", "device_kernels", "kernel_ms", "wall_ms")})
        out.append(dict(phase=calls[0]["tag"], calls=len(calls), relocalized=sum(c["relocalized"] for c in calls),
                        kf_capacity=int(store.kf_capacity), first_call_host_ms=first_host,
                        held_by_graph_mib=held, captures=graph.captures))
        del slam, eager, graph, store
    if not sync_checked or not traced:
        bad.append("no relocalizing call to check under sync debug \"error\" and to trace")
    live_ms = [c["host_ms"] for c in spied if c["relocalized"]]
    summary = dict(
        groups=out, eager_span_ms_median=statistics.median(eager_ms), replay_span_ms_median=statistics.median(replay_ms),
        replay_span_ms_max=max(replay_ms), replay_host_ms_median=statistics.median(replay_host),
        relocalize_host_ms=dict(median=statistics.median(live_ms), max=max(live_ms), n=len(live_ms)) if live_ms else None,
        frame_ms={k: dict(median=statistics.median(v), max=max(v), n=len(v)) for k, v in frame_ms.items() if v},
        traced=traced, eager_frame_ms_before=EAGER_RELOC_FRAME_MS, eager_kernel_ms_before=EAGER_CASCADE_KERNEL_MS)
    print(f"[17/22] b. relocalization: {json.dumps(summary)}", flush=True)
    if bad:
        raise AssertionError(f"17b: {bad}")
    return summary


def run_gba_reloc_phase(base: SLAMConfig, gba9: _GBACalls, reloc_calls: list, reloc_frame_ms: dict,
                        scale: dict) -> None:
    """Phase 17: the GBA chunk and commit (a) and the relocalization program
    (b) as CUDA graphs against their eager wrappers, and (c) the GBA graphs'
    captures across the scale run's closures."""
    t0 = time.perf_counter()
    run_gba_graph(base, gba9)
    run_reloc_graph(reloc_calls, reloc_frame_ms)
    c = dict(closures=scale["closure_calls"], gba=scale["gba_calls"], gba_capture_log=scale["gba_capture_log"],
             grows=[(g["frame"], g["frm"], g["to"]) for g in scale["grow"]])
    print(f"[17/22] c. scale run: {json.dumps(c)}", flush=True)
    if c["gba"]["commit"]["calls"] < 1:
        raise AssertionError(f"17c: no GBA committed in the scale run: {c}")
    print(f"[17/22] done in {time.perf_counter() - t0:.1f} s", flush=True)


class _LoopCalls:
    """While active, every ``LoopGraphs`` program call keeps its name, a
    CUDA-event pair around it (read after the run) and whether it captured.
    With ``keep`` the newest call of each program also keeps its inputs,
    cloned — the map (and database) it was given and its inputs — and the
    ``fuse_one`` calls after the newest ``correct_front`` their inputs (the
    map they write is the front's output; phase 18a replays the chain)."""

    def __init__(self, keep: bool = True):
        self.keep = keep

    def __enter__(self):
        from orb_slam2_ros2_tpu_torch.pipeline.frame_graph import tree_map
        from orb_slam2_ros2_tpu_torch.pipeline.loop_closing import LoopGraphs

        self.cls, self.calls, self.newest, self.fuses, self.vocab = LoopGraphs, [], {}, [], None
        run = self.orig = LoopGraphs._run

        def spy(graphs, name, fixed, *inputs):
            if self.keep:
                kept = tree_map(torch.clone, inputs)
                if name == "fuse_one":
                    self.fuses.append(kept)
                else:
                    self.newest[name] = (tree_map(torch.clone, fixed), kept)
                if name == "correct_front":
                    self.fuses = []
                self.vocab = graphs.vocab
            caps = graphs.captures
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            t0 = time.perf_counter()
            ev[0].record()
            out = run(graphs, name, fixed, *inputs)
            ev[1].record()
            self.calls.append(dict(name=name, events=ev, host_ms=(time.perf_counter() - t0) * 1000.0,
                                   captured=graphs.captures > caps))
            return out

        LoopGraphs._run = spy
        return self

    def __exit__(self, *exc):
        self.cls._run = self.orig

    def summary(self) -> dict:
        """By program: calls, captures with their host ms, replay spans
        (after a synchronise)."""
        torch.cuda.synchronize()
        out = {}
        for name in dict.fromkeys(c["name"] for c in self.calls):
            cs = [c for c in self.calls if c["name"] == name]
            rep = [c["events"][0].elapsed_time(c["events"][1]) for c in cs if not c["captured"]]
            out[name] = dict(calls=len(cs), captures=sum(c["captured"] for c in cs),
                             capture_host_ms=[round(c["host_ms"], 1) for c in cs if c["captured"]],
                             replay_span_ms_median=statistics.median(rep) if rep else None,
                             replay_span_ms_max=max(rep) if rep else None)
        return out


def run_loop_graphs(base: SLAMConfig, spied: _LoopCalls) -> dict:
    """18a: the newest call of each loop program in phase 9 and the
    closure's front with its fuses in order (kept by ``_LoopCalls``)
    through a fresh ``LoopGraphs`` and through the same static-buffer
    wrappers run eagerly (``capture=False``), each on its own copy of the
    map and database reset before every call: outputs, map and database
    bit-equal, a replay under sync debug "error", one replay traced (1
    graph launch, at most ``LOOP_HOST_LAUNCHES`` host launches) beside the
    eager trace; printed: eager and replay spans, the first call (eager run
    + capture), the memory the graphs hold."""
    from orb_slam2_ros2_tpu_torch.pipeline.frame_graph import tree_leaves, tree_map
    from orb_slam2_ros2_tpu_torch.pipeline.loop_closing import LoopGraphs

    want_names = ("detect", "sim3_a", "sim3_b", "sim3_c", "correct_front")
    bad = [f"phase 9 made no {n} call" for n in want_names if n not in spied.newest]
    if not spied.fuses:
        bad.append("phase 9's closure made no fuse_one call")
    if bad:
        raise AssertionError(f"18a: {bad}")
    eager, graph = LoopGraphs(base, spied.vocab, capture=False), LoopGraphs(base, spied.vocab)
    rows, first_ms = {}, {}

    def work(fixed):
        return tree_map(torch.clone, fixed)

    def reset(dst, fixed):
        torch._foreach_copy_(tree_leaves(dst), tree_leaves(fixed))

    def same(a, b) -> bool:
        la, lb = tree_leaves(a), tree_leaves(b)
        return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))

    def check(name, fixed, inputs, chain=()):
        """``name`` on ``inputs`` (then the fuses of ``chain``) eagerly and
        through the graph, each from ``fixed``."""
        w_e, w_g = work(fixed), work(fixed)

        def go(g, w):
            out = g._run(name, w, *inputs)
            return [out] + [g._run("fuse_one", w[:1], *f) for f in chain]

        want, e_span, e_host = _timed_call(lambda: go(eager, w_e))
        got, f_span, f_host = _timed_call(lambda: go(graph, w_g))   # eager run + capture (the fuses: 1)
        first_ms[name] = f_host
        if not (same(got, want) and same(w_g, w_e)):
            bad.append(f"{name}: the first call differs from the eager wrapper")
        spans, hosts = [], []
        for _ in range(2):
            reset(w_g, fixed)
            got, g_span, g_host = _timed_call(lambda: go(graph, w_g))
            spans.append(g_span)
            hosts.append(g_host)
            if not (same(got, want) and same(w_g, w_e)):
                bad.append(f"{name}: a replay differs from the eager wrapper")
        reset(w_g, fixed)
        with _sync_error():
            go(graph, w_g)
        torch.cuda.synchronize()
        reset(w_g, fixed)
        prof = kernel_profile(lambda: graph._run(name, w_g, *inputs))
        prof.pop("result")
        reset(w_e, fixed)
        eprof = kernel_profile(lambda: eager._run(name, w_e, *inputs))
        eprof.pop("result")
        if prof["graph_launches"] != 1 or prof["launches"] > LOOP_HOST_LAUNCHES:
            bad.append(f"{name}: traced replay {prof['graph_launches']} graph launches, {prof['launches']} host "
                       f"kernel launches (at most {LOOP_HOST_LAUNCHES})")
        rows[name] = dict(eager_span_ms=e_span, eager_host_ms=e_host, replay_span_ms=spans, replay_host_ms=hosts,
                          first_call_host_ms=f_host, calls=1 + len(chain),
                          traced_replay={k: prof[k] for k in ("graph_launches", "launches", "device_kernels",
                                                               "kernel_ms", "wall_ms")},
                          traced_eager={k: eprof[k] for k in ("launches", "device_kernels", "kernel_ms",
                                                              "wall_ms")})

    for name in ("detect", "frame_detect", "sim3_a", "sim3_b", "sim3_c"):
        if name in spied.newest:
            check(name, *spied.newest[name])
    fixed, inputs = spied.newest["correct_front"]
    check("correct_front", fixed, inputs)
    # the fuses in order on the front's output, one graph replayed n times
    front = work(fixed)
    eager._run("correct_front", front, *inputs)
    check("fuse_one", front, spied.fuses[0], chain=spied.fuses[1:])
    del front
    captures = graph.capture_log
    with_graphs = _held_mib(0)
    del graph   # what its pools and statics held
    gc.collect()
    held = with_graphs - _held_mib(0)
    kf_ids = [int(f[0]) for f in spied.fuses]
    summary = dict(programs=rows, fuse_ids=kf_ids, held_by_graphs_mib=held, captures=captures,
                   phase9=spied.summary())
    print(f"[18/22] a. loop graphs: {json.dumps(summary)}", flush=True)
    if len(captures) != len(rows):
        bad.append(f"captures {captures}: one a program")
    if bad:
        raise AssertionError(f"18a: {bad}")
    return summary


def run_loop_phase(base: SLAMConfig, loop9: _LoopCalls, loop: dict, scale: dict) -> None:
    """Phase 18: the loop programs as CUDA graphs against their eager
    wrappers (a), the closure frame's ``correct`` in its parts and the
    spike ratios (b), the loop-graph captures over phase 14c's grows and
    its peak memory (c)."""
    t0 = time.perf_counter()
    a = run_loop_graphs(base, loop9)
    parts = ("correct_front", "covis_read", "fuse", "optimize_essential", "correct")
    sp, kf = loop["span_ms"], scale["keyframe_span_ms"]
    b = {"9": dict({k: sp.get(k) for k in parts}, fuses=len(a["fuse_ids"]), spike_ratio=loop["spike_ratio"],
                   closure_frame=loop["closure_frame"], max_after_closure_ms=loop["max_after_closure_ms"],
                   median_frame_ms=loop["median_frame_ms"]),
         "14c": dict({k: kf.get(k) for k in parts}, spike_ratio=scale["spike_ratio"],
                     max_after_closure_ms=scale["max_after_closure_ms"], median_ms=scale["median_ms"]),
         "eager_before": EAGER_LOOP}
    print(f"[18/22] b. the closure's correct in parts: {json.dumps(b)}", flush=True)
    c = dict(loop_calls=scale["loop_calls"], grows=[(g["frame"], g["frm"], g["to"]) for g in scale["grow"]],
             grow_call_ms=[g["grow_call_ms"] for g in scale["grow"]], peak_mem_mib=scale["peak_mem_mib"],
             peak_mem_mib_before=EAGER_LOOP["14c"]["peak_mem_mib"])
    print(f"[18/22] c. scale run: {json.dumps(c)}", flush=True)
    caps = {n: v["captures"] for n, v in scale["loop_calls"].items()}
    if any(caps.get(n) != 1 + len(scale["grow"]) for n in LOOP_PROGRAMS):
        raise AssertionError(f"18c: loop-graph captures {caps}, want one at the warm-up and one a grow "
                             f"({len(scale['grow'])} grows)")
    print(f"[18/22] done in {time.perf_counter() - t0:.1f} s", flush=True)


def _bits_equal(xs, ys) -> torch.Tensor:
    """A device bool: every pair of tensors equal bit for bit (floats
    compared as their int32 bits); reads nothing back."""
    ok = torch.ones((), dtype=torch.bool, device=xs[0].device)
    for a, b in zip(xs, ys):
        if a.shape != b.shape or a.dtype != b.dtype:
            return torch.zeros_like(ok)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        ok = ok & torch.eq(a, b).all()
    return ok


class _BookkeepCheck:
    """While active, every ``KeyframeGraphs.bookkeep`` call (the split's
    per-frame bookkeeping) is first run, on copies of the map storage it is
    given, through a fresh ``KeyframeGraphs`` over the same program (its
    calls under sync debug "error") and through the same wrapper run
    eagerly; the outputs and the storages are compared on the device and
    read after the run.  The first call of the fresh graph (eager run +
    capture) is timed and the memory it holds measured; each later call
    keeps CUDA-event spans of the replay and of the eager wrapper."""

    def __enter__(self):
        from orb_slam2_ros2_tpu_torch.mapstate.map_state import MapState
        from orb_slam2_ros2_tpu_torch.pipeline.frame_graph import KeyframeGraphs, tree_leaves

        self.cls, self.orig = KeyframeGraphs, KeyframeGraphs.bookkeep
        self.graph = self.eager = self.stores = self.last = None
        self.flags, self.events, self.first_ms, self.held_mib = [], [], None, None
        orig = self.orig

        def spy(kg, storage, *args):
            if self.graph is None:
                self.graph = KeyframeGraphs(None, None, None, kg._bookkeep)
                self.eager = KeyframeGraphs(None, None, None, kg._bookkeep, capture=False)
                self.stores = [MapState(*(t.clone() for t in storage)) for _ in range(2)]
            else:
                torch._foreach_copy_([*self.stores[0], *self.stores[1]], [*storage, *storage])
            first = self.graph.captures == 0
            if first:   # the first tracked frame: no sync debug mode is set yet
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                reserved0, t0 = torch.cuda.memory_reserved(), time.perf_counter()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            with _sync_error():
                got = orig(self.graph, self.stores[0], *args)
            ev[1].record()
            if first:
                torch.cuda.synchronize()
                self.first_ms = (time.perf_counter() - t0) * 1000.0
                self.held_mib = _held_mib(reserved0)
            ev[2].record()
            want = orig(self.eager, self.stores[1], *args)
            ev[3].record()
            self.flags.append(_bits_equal([*tree_leaves(got), *self.stores[0]],
                                          [*tree_leaves(want), *self.stores[1]]))
            if not first:
                self.events.append(ev)
            self.last = args
            return orig(kg, storage, *args)

        KeyframeGraphs.bookkeep = spy
        return self

    def __exit__(self, *exc):
        self.cls.bookkeep = self.orig


def run_eager_mesh_route(base: SLAMConfig, multi: dict) -> dict:
    """19d: the route of a mesh that ``Mesh.capturable`` refuses (several
    processes or GPUs), on the one card through ``REFUSED_MESH_DEVICES``.
    13b's closure through ``EssentialGraph`` over that mesh, twice (the
    problem and the commit captured, then replayed; the sharded GN steps
    eager between them), and 13b's chunks through ``GBAGraphs.step`` over
    it (the system's chunk: ``step_global_ba``, eagerly, the shards carried
    from chunk to chunk as the system carries them), each bit-equal to the
    eager programs over 13b's mesh; then the last chunk's iterate through
    the commit graph, captured and replayed, against ``commit_global_ba``.
    Returns the summary."""
    from functools import partial

    from orb_slam2_ros2_tpu_torch.mapstate.map_state import MapState
    from orb_slam2_ros2_tpu_torch.parallel import ba_mesh
    from orb_slam2_ros2_tpu_torch.pipeline.loop_closing import EssentialGraph, optimize_essential
    from orb_slam2_ros2_tpu_torch.solvers import pose_graph as pg_mod
    from orb_slam2_ros2_tpu_torch.solvers.global_ba import GBAGraphs, commit_global_ba, step_global_ba

    t0 = time.perf_counter()
    rec = multi["recorded"]
    mesh13 = rec["essential"].mesh
    mesh = ba_mesh(mesh13.size, axis=mesh13.axis, devices=REFUSED_MESH_DEVICES)
    if mesh.capturable or not mesh13.capturable:
        raise AssertionError(f"19d: capturable {mesh.capturable} over {REFUSED_MESH_DEVICES}, "
                             f"{mesh13.capturable} over 13b's mesh")
    bad = []

    state, kf_cur, kf_cand, S12, S_nc, gmask, pre = rec["essential"].inputs
    weight = base.loop.essential_graph_weight
    want, want_span, _ = _timed_call(lambda: optimize_essential(
        state, kf_cur, kf_cand, S12, S_nc, gmask, pre, essential_weight=weight,
        pose_graph_fn=partial(pg_mod.optimize_pose_graph, iters=ESSENTIAL_ITERS, mesh=mesh13,
                              mesh_axis=mesh13.axis)))
    g = EssentialGraph(essential_weight=weight, mesh=mesh)
    ess_spans = []
    with _Spy(pg_mod, "_gn_step_pcg_sharded") as steps:
        for i in range(2):   # the parts' captures, then their replays
            out, span, _ = _timed_call(lambda: g(state, kf_cur, kf_cand, S12, S_nc, gmask, pre))
            ess_spans.append(span)
            bad += [f"essential graph, call {i}: {f} differs from the eager program over 13b's mesh"
                    for f in ("kf_Tcw", "mp_pos") if not torch.equal(getattr(out, f), getattr(want, f))]
    parts = {name: [p.captures, p.replays] for name, p in zip(("problem", "gn_step", "commit"), g.parts)}
    if steps.calls != 2 * ESSENTIAL_ITERS or parts != dict(problem=[1, 1], gn_step=[0, 0], commit=[1, 1]):
        bad.append(f"essential graph: {steps.calls} eager sharded steps, parts [captures, replays] {parts}")

    b = base.ba
    kw = dict(n_iters=1, pcg_iters=b.pcg_iters, chi2_mono=b.chi2_mono, chi2_stereo=b.chi2_stereo)
    graphs, out, rows = GBAGraphs(**kw), None, []
    for i, (pend, cam, robust_after, capacity, _) in enumerate(rec["gba"].chunks):
        pend = pend if out is None else pend._replace(shards=out.shards)
        out, span, _ = _timed_call(lambda: graphs.step(pend, cam, robust_after=robust_after, capacity=capacity,
                                                       mesh=mesh))
        ref = step_global_ba(pend, cam, robust_after=robust_after, mesh=mesh13, axis=mesh13.axis, **kw)
        if not (torch.equal(out.Tcw, ref.Tcw) and torch.equal(out.ptsT, ref.ptsT)):
            bad.append(f"chunk {i}: differs from step_global_ba over 13b's mesh")
        rows.append(dict(chunk=i, gated=pend.chunks_done >= robust_after, span_ms=span))
    n_chunks = len(rows)
    if graphs.eager_chunks != n_chunks or graphs.chunk_replays or graphs.captures:
        bad.append(f"chunks: {graphs.eager_chunks} eager of {n_chunks}, {graphs.chunk_replays} replays, "
                   f"{graphs.captures} captures")
    state, _, depth = rec["gba"].commit_in
    into = MapState(*(t.clone() for t in state))
    plain = commit_global_ba(state, out, propagate_depth=depth)
    commit_spans = []
    for i in range(2):   # the capture, then a replay on the pre-commit map at the same addresses
        if i:
            torch._foreach_copy_(list(into), list(state))
        _, span, _ = _timed_call(lambda: graphs.commit(into, out, propagate_depth=depth))
        commit_spans.append(span)
        bad += [f"commit, call {i}: {n} differs from commit_global_ba"
                for n, a, p in zip(MapState._fields, into, plain) if not torch.equal(a, p)]
    if graphs.captures != 1 or graphs.commit_replays != 1:
        bad.append(f"commit: {graphs.captures} captures, {graphs.commit_replays} replays (want 1 and 1)")
    d = dict(devices=REFUSED_MESH_DEVICES, capturable=mesh.capturable, shards=mesh.size,
             essential=dict(eager_program_span_ms=want_span, capture_call_span_ms=ess_spans[0],
                            replay_call_span_ms=ess_spans[1], eager_sharded_steps=steps.calls,
                            parts_captures_replays=parts,
                            phase13b_graph_ms=multi["b"]["spans_ms"]["optimize_essential"]),
             chunks=dict(eager=graphs.eager_chunks, replays=graphs.chunk_replays, rows=rows,
                         phase13b_graph_ms=multi["b"]["spans_ms"]["gba_chunk"]),
             commit=dict(capture_call_span_ms=commit_spans[0], replay_span_ms=commit_spans[1],
                         captures=graphs.captures, replays=graphs.commit_replays),
             seconds=time.perf_counter() - t0)
    print(f"[19/22] d. the eager mesh route (a mesh Mesh.capturable refuses): {json.dumps(d)}", flush=True)
    if bad:
        raise AssertionError(f"19d: {bad}")
    return d


def run_mesh_graphs(base: SLAMConfig, multi: dict) -> list:
    """Phase 19: the closure of 13b through fresh mesh graphs (a: every GBA
    chunk and the commit, a second snapshot; b: the essential graph, a
    second closure), each against the same wrappers run eagerly, (c)
    13c's split world again with every bookkeeping call checked as it
    comes (``_BookkeepCheck``), and (d) 13b's closure over a mesh that is
    not capturable (``run_eager_mesh_route``).  Returns the launch counts
    of (c)'s run."""
    t0 = time.perf_counter()
    rec = multi["recorded"]
    run_gba_graph(base, rec["gba"], tag="19/22] a")
    run_essential_graph(base, rec["essential"], multi["b_loop"], tag="19/22] b")

    split = multi["split"]
    with _BookkeepCheck() as check:
        recs, launches, sm, slam, _ = run_mapping(split["cfg"], "split", "19/22", devices=MULTI_DEVICES)
    bad = [i for i, f in enumerate(check.flags) if not bool(f)]
    diff = max(float(np.abs(a - b).max()) for (_, a), b in zip(slam.trajectory, split["poses"]))
    storage, args = check.stores[0], check.last
    with _sync_error():
        check.graph.bookkeep(storage, *args)
    torch.cuda.synchronize()
    prof = kernel_profile(lambda: check.graph.bookkeep(storage, *args))
    prof.pop("result")
    replay = [ev[0].elapsed_time(ev[1]) for ev in check.events]
    eager = [ev[2].elapsed_time(ev[3]) for ev in check.events]
    c = dict(calls=len(check.flags), bit_equal=not bad, first_call_ms=check.first_ms,
             held_by_graph_mib=check.held_mib, captures=check.graph.captures, replays=check.graph.replays,
             replay_span_ms=dict(median=statistics.median(replay), max=max(replay)),
             eager_wrapper_span_ms=dict(median=statistics.median(eager), max=max(eager)),
             phase13c_bookkeep_ms=multi["c"]["spans_ms"]["bookkeep"], pose_diff_vs_13c=diff,
             traced_replay={k: prof[k] for k in ("graph_launches", "launches", "device_kernels", "kernel_ms",
                                                 "wall_ms", "api")})
    print(f"[19/22] c. the split's bookkeeping: {json.dumps(c)}", flush=True)
    problems = [f"call {i}: the replay or the storage differs from the eager wrapper" for i in bad]
    if diff != 0.0:
        problems.append(f"the rerun's poses left 13c's by {diff}")
    if check.graph.captures != 1 or len(check.flags) != sm["program_span_ms"]["bookkeep"]["n"]:
        problems.append(f"{check.graph.captures} captures over {len(check.flags)} checked calls")
    if prof["graph_launches"] != 1 or prof["launches"] > BOOKKEEP_HOST_LAUNCHES:
        problems.append(f"traced replay: {prof['graph_launches']} graph launches, {prof['launches']} host kernel "
                        f"launches (at most {BOOKKEEP_HOST_LAUNCHES}: copies in, the id fill, clones out)")
    if problems:
        raise AssertionError(f"19c: {problems}")
    del slam, check, storage, args
    run_eager_mesh_route(base, multi)
    print(f"[19/22] done in {time.perf_counter() - t0:.1f} s", flush=True)
    return [launches]


# the measurement tools (phase 20): each tool's arguments on the card — the
# JAX scripts' depths but where PERF.md lists a cut
TOOL_ARGS = {
    "profile_scan": [],
    "profile_extract": [],
    "profile_trace": [],
    "bench_micro": [],
    "profile_frame": [],
    "profile_full": [],
    "profile_loop": [],
    "profile_kf": [],
    "profile_ba": [],
    "bench_posegraph": ["--reps", "1"],
    "bench_posegraph:small": ["--sizes", "64:128", "--dense-max-k", "64", "--reps", "1"],
    "bench_io": [],
    "profile_orbvoc": [],
}
# what each tool's result must hold
TOOL_KEYS = {
    "profile_scan": ("ms_per_frame", "delta_ms"),
    "profile_extract": ("ms_per_frame", "delta_ms"),
    "profile_trace": ("replays", "sessions", "fast_nms", "patches", "top", "csv"),
    "bench_micro": ("ms_per_frame",),
    "profile_frame": ("ms_per_frame", "delta_ms", "tracked", "keyframes"),
    "profile_full": ("fps", "stages", "frame_total", "tracked", "total_frames"),
    "profile_loop": ("classes", "all_mean_ms", "tracked", "total_frames"),
    "profile_kf": ("programs", "tracked"),
    "profile_ba": ("programs", "absent"),
    "bench_posegraph": ("runs", "pcg_vs_dense", "pcg_K256_ms", "dense_K256_ms", "pcg_K1024_ms", "dense_K1024_ms",
                        "pcg_K2048_ms"),
    "bench_posegraph:small": ("runs", "pcg_vs_dense", "pcg_K64_ms", "dense_K64_ms"),
    "bench_io": ("formats", "max_kf_translation", "proto_vs_txt_time", "proto_vs_txt_size"),
    "profile_orbvoc": ("orbvoc_live", "vocab_write_s", "add_detect_ratio"),
}
POSE_GRAPH_ROUTE_TOL = 2e-3   # tests/test_torch_pose_graph.py (dense and PCG against JAX)
# the largest K at which 150 CG iterations a step bring the PCG route to the
# dense route's poses in 20 steps (CPU: 7e-5 apart at 64, 0.023 at 128,
# 0.36 at 256, where 1000 CG iterations a step agree to 2.5e-4)
POSE_GRAPH_AGREE_K = 64


def _times(obj, path=()):
    """(path, value) of every time in a tool's result: the values of keys
    ending in ``ms`` or ``_s`` and of ``ms_per_frame``, ``stages``' and
    ``classes``' entries, ``fps`` — not the stage deltas, which noise may
    make negative."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            if k not in ("delta_ms", "top", "sessions"):
                yield from _times(v, path + (k,))
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            yield from _times(v, path + (i,))
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool) and path:
        key = str(path[-1])
        named = key == "ms" or key.endswith(("_ms", "_s")) or key in ("fps", "mean", "median", "max", "total", "pre", "fetch",
                                                          "post")
        if named or "ms_per_frame" in path or "programs" in path:
            yield path, obj


def check_tool(key: str, out: dict) -> list:
    """The problems of one tool's result (phase 20's gates); ``key`` is the
    tool's name, or ``name:variant`` for a second run of it."""
    name = key.split(":")[0]
    problems = [f"{key}: no {k}" for k in TOOL_KEYS[key] if k not in out]
    # (profile_orbvoc's vocab_write_s is 0 where build/ already held the file)
    bad = [(p, v) for p, v in _times(out) if not (math.isfinite(v) and v > 0) and p != ("vocab_write_s",)]
    problems += [f"{name}: {'.'.join(map(str, p))} = {v}" for p, v in bad]
    if name == "profile_frame" and out["ms_per_frame"]["full"] < out["ms_per_frame"]["frontend"]:
        problems.append(f"profile_frame: full {out['ms_per_frame']['full']} < frontend "
                        f"{out['ms_per_frame']['frontend']}")
    if name == "profile_trace":
        n = out["replays"]
        if out["fast_nms"] != n or out["patches"] != n or any(
                s["fast_nms"] > n or s["patches"] > n for s in out["sessions"]):
            problems.append(f"profile_trace: K1 / K2 seen {[(s['fast_nms'], s['patches']) for s in out['sessions']]}"
                            f" times in {n} replays")
    if name == "bench_posegraph":
        problems += [f"bench_posegraph: K={r['K']} {r['route']} replays not bit-equal to the eager solve"
                     for r in out["runs"] if not r["bit_equal"]]
        problems += [f"bench_posegraph: K={r['K']} {r['route']} cost {r['cost']} not under a tenth of "
                     f"{r['start_cost']}" for r in out["runs"] if not r["cost"] < 0.1 * r["start_cost"]]
        # where both routes ran: the dense route (exact GN) at least as low as
        # PCG's, and within the tests' tolerance of it where PCG converges
        by = {(r["K"], r["route"]): r for r in out["runs"]}
        for K in sorted({k for k, _ in by}):
            if (K, "dense") in by:
                if not by[K, "dense"]["cost"] <= by[K, "pcg"]["cost"] * (1 + 1e-3):
                    problems.append(f"bench_posegraph: K={K} dense cost {by[K, 'dense']['cost']} over PCG's "
                                    f"{by[K, 'pcg']['cost']}")
                d = out["pcg_vs_dense"][f"K{K}"]
                if K <= POSE_GRAPH_AGREE_K and not d <= POSE_GRAPH_ROUTE_TOL:
                    problems.append(f"bench_posegraph: PCG and dense {d} apart at K={K}")
    if name == "bench_io":
        problems += [f"bench_io: {f} load differs from the saved state" for f, r in out["formats"].items()
                     if r["load_equal"] is not True]
    if name == "profile_orbvoc":
        runs = out["orbvoc_live"]
        if runs[1]["n_words"] != 10 ** 6:
            problems.append(f"profile_orbvoc: the scale run has {runs[1]['n_words']} words")
        problems += [f"profile_orbvoc: {r['label']} tracked {r['tracked']} of {r['frames']}" for r in runs
                     if r["tracked"] != r["frames"]]
    if name in ("profile_full", "profile_loop") and out["tracked"] != out["total_frames"]:
        problems.append(f"{name}: tracked {out['tracked']} of {out['total_frames']}")
    return problems


def run_tools(args: dict = None) -> dict:
    """Phase 20: every measurement tool's ``main`` in this process on the
    card (``TOOL_ARGS``), each result held to ``check_tool``, the graphs of
    one tool dropped and the cache emptied before the next.  Returns the
    K1 / K2 launches: the wrappers' own and those inside the tools' graph
    replays (``tools._timing.graph_kernels``)."""
    import importlib

    from orb_slam2_ros2_tpu_torch.tools import _timing as tool_timing

    t0 = time.perf_counter()
    _reset_launches()
    tool_timing.reset_counts()
    problems, seconds = [], {}
    for name, argv in (args or TOOL_ARGS).items():
        t1 = time.perf_counter()
        mod = importlib.import_module(f"orb_slam2_ros2_tpu_torch.tools.{name.split(':')[0]}")
        out = mod.main(list(argv))
        seconds[name] = time.perf_counter() - t1
        found = check_tool(name, out)
        problems += found
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        print(f"[20/22] {name} ({seconds[name]:.1f} s, peak {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB): "
              f"{'ok' if not found else found}", flush=True)
    launches = {**_launches(), **{f"graph_{k}": v for k, v in tool_timing.graph_kernels.items()}}
    print(f"[20/22] done in {time.perf_counter() - t0:.1f} s; tool seconds {json.dumps(seconds)}; launches "
          f"{json.dumps(launches)}", flush=True)
    if problems:
        raise AssertionError(f"phase 20: {problems}")
    return launches


# the benches (phase 21): bench_scaling's mesh sizes against the unsharded
# solve on the dry run's corridor (entry.gba_problem) at phase 13a's C=256
# and P=25,000 with bench_scaling's solver settings.  In float64 every
# camera and point is held to tests/test_torch_sharded_solvers.py's
# tolerances.  In float32, the production dtype, the bound is the rounding
# floor: the corridor's yaw turns its last cameras away from the points
# (cameras 141-147 see 1-4 points, 148-255 none), so a reordering of the
# same problem's points moves the float32 unsharded solve by up to 2.18 mm,
# 0.0066° and a point excess of 0.54 mm (14 reorderings on the CPU), where
# the float64 solve moves by 2e-12 m
BENCH_SCALING_ARGS = ["--reps", "1"]
CORRIDOR_C, CORRIDOR_P = 256, 25_000
SHARDED_TOL = {torch.float64: dict(pose_diff_m=1e-4, rot_diff_deg=1e-3, point_excess_m=0.0, gate_diff=2),
               torch.float32: dict(pose_diff_m=5e-3, rot_diff_deg=1e-2, point_excess_m=2e-3, gate_diff=2)}
SCALING_POSE_TOL = SHARDED_TOL[torch.float64]


def _bench_call(mod, argv) -> tuple:
    """(result, exit code) of a bench's ``main``: 1 where it raised
    ``Failed`` after its lines (its gate failed)."""
    from orb_slam2_ros2_tpu_torch.tools import _timing as tool_timing

    try:
        return mod.main(list(argv)), 0
    except tool_timing.Failed as e:
        return e.result, e.code


def run_corridor_shards(dtype, shards, seed: int = 0, device: str = "cuda") -> dict:
    """The dry run's corridor in ``dtype`` on ``device``, solved unsharded and
    over each mesh size of ``shards`` with ``bench_scaling``'s settings:
    ``entry.gba_gap`` of each sharded solve from the unsharded one, and
    under ``"reordered"`` that of the unsharded solve of the same problem
    with its points in a random order (the rounding floor)."""
    from orb_slam2_ros2_tpu_torch import entry
    from orb_slam2_ros2_tpu_torch.geometry.camera import CameraParams
    from orb_slam2_ros2_tpu_torch.parallel.mesh import ba_mesh
    from orb_slam2_ros2_tpu_torch.solvers.pcg_ba import PointBAProblem, solve_global_ba, solve_global_ba_sharded
    from orb_slam2_ros2_tpu_torch.tools.bench_scaling import SOLVER

    def cast(t):
        return t.to(dtype) if t.is_floating_point() else t

    cam, prob = entry.gba_problem(CORRIDOR_C, CORRIDOR_P, device=device)
    cam, prob = CameraParams(*map(cast, cam)), PointBAProblem(*map(cast, prob))
    one = solve_global_ba(cam, prob, **SOLVER)
    out = {str(n): entry.gba_gap(solve_global_ba_sharded(cam, prob, ba_mesh(n, devices=[device] * n), **SOLVER),
                                 one, prob.pt_valid) for n in shards}
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(CORRIDOR_P)).to(device)
    T, p, g = solve_global_ba(cam, PointBAProblem(*(t[perm] if t.shape[0] == CORRIDOR_P else t for t in prob)),
                              **SOLVER)
    inv = torch.argsort(perm)
    out["reordered"] = entry.gba_gap((T, p[inv], g[:, inv]), one, prob.pt_valid)
    return out


def run_benches() -> dict:
    """Phase 21: ``tools.bench`` (with its ``bench_full`` subprocess),
    ``tools.bench_loop`` and ``tools.bench_scaling`` in this process on the
    card at the JAX scripts' sizes (``bench_scaling`` timed once a mesh
    size), each result gated, then ``bench_scaling``'s mesh sizes on the
    corridor.  Returns the K1 / K2 launches: the wrappers' own and one each
    a frame-graph replay of the benches' SLAMs (``note_slam``)."""
    from orb_slam2_ros2_tpu_torch.tools import _timing as tool_timing
    from orb_slam2_ros2_tpu_torch.tools import bench, bench_loop, bench_scaling

    t0 = time.perf_counter()
    _reset_launches()
    tool_timing.reset_counts()
    problems, seconds = [], {}

    def ran(name, t1):
        seconds[name] = time.perf_counter() - t1
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    t1 = time.perf_counter()
    out, rc = _bench_call(bench, [])
    ran("bench", t1)
    replays = dict(tool_timing.graph_kernels)
    full, gate = out["full_slam"], out["quality_gate"]
    if rc != 0:
        problems.append(f"bench: exit code {rc}")
    if not (gate["pass"] and gate["median_inliers"] >= MIN_MEDIAN_INLIERS):
        problems.append(f"bench: median inliers {gate['median_inliers']} < {MIN_MEDIAN_INLIERS}")
    fd = (full or {}).get("detail", {})
    if full is None or full["rc"] != 0 or fd.get("ate_gate_pass") is not True or fd["tracked"] != fd["n_frames"]:
        problems.append(f"bench_full: {json.dumps(full)[:3000]}")
    want = (1 + 3) * bench.N_FRAMES   # the return pass's replays: the untimed run and 3 timed
    if not (replays["fast_nms"] == replays["patches"] == replays["brief"] >= want):
        problems.append(f"bench: K1 / K2 / K3 in {replays} frame-graph replays, want ≥ {want}")
    headline = {k: out[k] for k in ("metric", "value", "unit", "vs_baseline")}
    print(f"[21/22] bench ({seconds['bench']:.1f} s): {json.dumps(headline)}; detail {json.dumps(out['detail'])}; gate "
          f"{json.dumps(gate)}; K1 / K2 / K3 in frame-graph replays {json.dumps(replays)}", flush=True)
    print(f"[21/22] bench_full (subprocess, its launches counted in its own process): {json.dumps(full)}",
          flush=True)

    t1 = time.perf_counter()
    loop, rc = _bench_call(bench_loop, [])
    ran("bench_loop", t1)
    ratio = loop["value"]
    if rc != 0 or ratio is None or not (math.isfinite(ratio) and ratio > 0) or not loop["detail"]["closures"]:
        problems.append(f"bench_loop: {json.dumps(loop)}")
    print(f"[21/22] bench_loop ({seconds['bench_loop']:.1f} s): {json.dumps(loop)}", flush=True)

    t1 = time.perf_counter()
    scaling, rc = _bench_call(bench_scaling, BENCH_SCALING_ARGS)
    ran("bench_scaling", t1)
    start = scaling["robust_cost"]["start"]
    problems += [f"bench_scaling: after the {n}-slot solve cost {c}, robust cost {scaling['robust_cost'][n]} "
                 f"(start {start})" for n, c in scaling["cost"].items()
                 if n != "start" and not (math.isfinite(c) and scaling["robust_cost"][n] < start)]
    problems += [f"bench_scaling: {n} slots {t} s" for n, t in scaling["seconds"].items()
                 if not (math.isfinite(t) and t > 0)]
    problems += [f"bench_scaling: {n} slots {json.dumps(d)} from the unsharded poses"
                 for n, d in scaling["pose_diff_vs_1"].items()
                 if not (d["m"] <= SCALING_POSE_TOL["pose_diff_m"] and d["deg"] <= SCALING_POSE_TOL["rot_diff_deg"])]
    if rc != 0:
        problems.append(f"bench_scaling: exit code {rc}")
    print(f"[21/22] bench_scaling ({seconds['bench_scaling']:.1f} s): {json.dumps(scaling)}", flush=True)

    shards = [int(n) for n in scaling["seconds"] if n != "1"]
    for dtype in (torch.float64, torch.float32):
        name, t1 = f"corridor_{str(dtype)[-7:]}", time.perf_counter()
        gaps = run_corridor_shards(dtype, shards)
        ran(name, t1)
        tol = SHARDED_TOL[dtype]
        problems += [f"{name}, {n} slots: {json.dumps(r)} beyond {json.dumps(tol)}" for n, r in gaps.items()
                     if n != "reordered" and any(r[k] > lim for k, lim in tol.items())]
        print(f"[21/22] the corridor C={CORRIDOR_C} P={CORRIDOR_P} in {dtype} with bench_scaling's settings "
              f"({seconds[name]:.1f} s): each mesh size against the unsharded solve {json.dumps(gaps)}, "
              f"gated at {json.dumps(tol)} (the 'reordered' entry, the unsharded solve of the points in "
              f"another order, is the rounding floor and not gated)", flush=True)

    launches = {**_launches(), **{f"graph_{k}": v for k, v in tool_timing.graph_kernels.items()}}
    print(f"[21/22] done in {time.perf_counter() - t0:.1f} s; seconds {json.dumps(seconds)}; launches "
          f"{json.dumps(launches)}", flush=True)
    if problems:
        raise AssertionError(f"phase 21: {problems}")
    return launches


# ------------------------------------------------------------------ phase 22 --
# the lens-distortion path, image noise, a forced weak frame and the one-slot
# dry run
TUM_YAML = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "tum_fr2.yaml")
DIST_ATE_RATIO = 2.5      # tests/test_distorted_e2e.py:109
DIST_ATE_PATH = 0.03
DIST_MIN_MAPPOINTS = 300
NOISE_FRAMES = 25         # tests/test_slam_e2e.py:172-194
NOISE_SPEED = 0.35
NOISE_SIGMA = 6.0         # grey levels
NOISE_SEED = 42
NOISE_MIN_TRACKED = 0.9
NOISE_MAX_ATE = 0.08      # fraction of n × speed
WEAK_FRAMES = 12
WEAK_MIN_KEYFRAMES = 2    # keyframes before the forced weak frame
WEAK_MAX_ERR_M = 0.05
WEAK_POSE_TOL_M, WEAK_POSE_TOL_DEG = 1e-2, 0.1   # tests/test_torch_pipelined.py


def _graph_ms(fn) -> float:
    """Device ms of one replay of ``fn`` captured as a CUDA graph (eager,
    its small kernels are host-bound)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            fn()
    finally:
        gc.enable()
    return device_ms(graph.replay)


def run_distorted() -> tuple:
    """22a: ``configs/tum_fr2.yaml`` as shipped (its lens) on phase 8's
    world: the pinhole frames through its intrinsics without the lens, and
    the same frames warped into the lens (``warp_to_distorted``) through
    the configuration itself, each a ``run_rgbd``.  22b: ``cli tum
    --config configs/tum_fr2.yaml`` on a TUM layout of the warped frames.
    Returns (launch counts of the three runs, summary)."""
    from orb_slam2_ros2_tpu_torch.geometry.camera import CameraParams, undistort_points

    cfg = SLAMConfig.from_yaml(TUM_YAML)
    c = cfg.camera
    if not (c.has_distortion and (c.width, c.height) == (640, 480) and cfg.orb.n_features == 2000
            and cfg.tracking.th_depth == 40.0 and c.camera_type == 1):
        raise AssertionError(f"{TUM_YAML} is not the shipped TUM fr2 configuration: {cfg}")
    pin_cfg = cfg.replace(camera=dataclasses.replace(c, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0))
    cam = CameraParams.from_config(c, "cuda")
    t0 = time.perf_counter()
    frames_pin = rgbd_frames(pin_cfg)
    frames_dist = rgbd_frames(pin_cfg, warp_cam=cam)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    pin_rec, pin_launches, pin = run_rgbd(pin_cfg, frames_pin, tag="22/22] a pinhole")
    dist_rec, dist_launches, dist = run_rgbd(cfg, frames_dist, tag="22/22] a distorted")
    path = dist["path_len_m"]
    bar = max(DIST_ATE_RATIO * pin["ate_m"], DIST_ATE_PATH * path)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    uv = torch.rand((cfg.orb.max_keypoints, 2), generator=gen, device="cuda")
    uv = uv * torch.tensor([c.width - 1.0, c.height - 1.0], device="cuda")
    out = dict(config="configs/tum_fr2.yaml", dist=[c.k1, c.k2, c.p1, c.p2, c.k3], render_and_warp_s=render_s,
               ate_pinhole_m=pin["ate_m"], ate_distorted_m=dist["ate_m"], path_len_m=path,
               ate_gate_m=bar, ate_phase8_gate_m=MAX_ATE_RGBD * path,
               n_mappoints=dist["n_mappoints"], n_keyframes=[pin["n_keyframes"], dist["n_keyframes"]],
               captures=[pin["frame_graph_captures"], dist["frame_graph_captures"]],
               frame_ms_pinhole=dict(keyframe=_frame_ms(pin_rec, True), other=_frame_ms(pin_rec, False)),
               frame_ms_distorted=dict(keyframe=_frame_ms(dist_rec, True), other=_frame_ms(dist_rec, False)),
               replay_device_ms=dict(pinhole=pin["replay_device_ms"], distorted=dist["replay_device_ms"]),
               undistort_graph_ms=_graph_ms(lambda: undistort_points(cam, uv)),
               undistort_points_n=uv.shape[0],
               uv_outside_image=dist["uv_outside_image"],
               max_trans_err_m=[max(r["trans_err_m"] for r in pin_rec), max(r["trans_err_m"] for r in dist_rec)])
    print(f"[22/22] a distorted RGB-D: {json.dumps(out)}", flush=True)
    problems = []
    if not dist["ate_m"] < bar:
        problems.append(f"distorted ATE {dist['ate_m']:.4f} m ≥ max({DIST_ATE_RATIO} × pinhole "
                        f"{pin['ate_m']:.4f}, {DIST_ATE_PATH} × {path:.3f}) m")
    if not dist["n_mappoints"] > DIST_MIN_MAPPOINTS:
        problems.append(f"{dist['n_mappoints']} map points ≤ {DIST_MIN_MAPPOINTS}")
    if out["captures"] != [1, 1]:
        problems.append(f"frame-graph captures {out['captures']}, want one a run")
    if problems:
        raise AssertionError(f"phase 22a: {problems}")

    # b. the command TUM users run, on the warped frames written to disk
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = write_tum_layout(f"{tmp}/tum", pin_cfg, RGBD_FRAMES,
                                warp=lambda img, depth: warp_to_distorted(cam, img, depth))
        layout_s = time.perf_counter() - t0
        args = ["--config", TUM_YAML]
        res = run_cli(["tum", "--seq", f"{tmp}/tum", "--device", "cuda", "--out", f"{tmp}/t", *args])
        _check_run("tum distorted", res, RGBD_FRAMES, SHELL_LOST, path, f"{tmp}/t", min_keyframes=2)
    res.update(layout_write_s=layout_s, path_len_m=path)
    print(f"[22/22] b cli tum --config configs/tum_fr2.yaml on the warped layout: {json.dumps(res)}", flush=True)
    out["cli_tum"] = {k: res.get(k) for k in ("frames", "tracked", "keyframes", "ate_rmse", "fps", "captures")}
    return [pin_launches, dist_launches, res["launches"]], out


def run_noise(base: SLAMConfig) -> tuple:
    """22c: ``tests/test_slam_e2e.py``'s noise scenario at the default
    ``SLAMConfig()``: full SLAM over 25 frames of the default world at 0.35
    m/frame, i.i.d. Gaussian noise of σ = 6 grey levels on both images,
    drawn on the card from a seeded generator before each call.  Returns
    (launch counts, summary)."""
    ds = SyntheticStereoDataset(base.camera, n_frames=NOISE_FRAMES, speed=NOISE_SPEED, device="cuda")
    frames = [ds.frame(i) for i in range(NOISE_FRAMES)]  # rendered on the card, set-up
    gen = torch.Generator(device="cuda")
    gen.manual_seed(NOISE_SEED)
    slam = SLAM(base, device="cuda")
    torch.cuda.synchronize()

    _reset_launches()
    records, est, gt = [], [], []
    for i, (img_l, img_r, Twc_gt) in enumerate(frames):
        noisy_l = img_l + NOISE_SIGMA * torch.randn(img_l.shape, generator=gen, device="cuda")
        noisy_r = img_r + NOISE_SIGMA * torch.randn(img_r.shape, generator=gen, device="cuda")
        # a tracked frame's program runs without host syncs
        slam.frame_sync_debug_mode = "error" if i >= 2 and slam.state == TrackState.OK else None
        pose, stats, ms = _track(slam, f"noise {i}", noisy_l, noisy_r, profile=i == PROFILED_CALL)
        rec = dict(frame=i, ms=ms, profiled=i == PROFILED_CALL, state=slam.state.name,
                   n_inliers=stats.get("n_inliers"), n_kf=slam._n_kf,
                   trans_err_m=None if pose is None else _trans_err(pose, Twc_gt))
        print(f"[22/22] c noise frame {i}: {json.dumps(rec)}", flush=True)
        records.append(rec)
        if pose is not None:
            est.append(np.linalg.inv(pose.astype(np.float64)))
            gt.append(Twc_gt)
    slam.flush()
    torch.cuda.synchronize()
    slam.frame_sync_debug_mode = None
    launches = _launches()
    path = NOISE_FRAMES * NOISE_SPEED
    ate = ate_rmse(est, gt) if est else float("inf")
    out = dict(frames=NOISE_FRAMES, tracked=len(est), sigma=NOISE_SIGMA, ate_m=ate, path_m=path,
               ate_gate_m=NOISE_MAX_ATE * path,
               median_inliers=statistics.median(r["n_inliers"] for r in records[1:] if r["n_inliers"] is not None),
               n_keyframes=slam.n_keyframes, n_mappoints=slam.n_mappoints,
               frame_ms_median=statistics.median(r["ms"] for r in records[2:] if not r["profiled"]),
               captures=_captures(slam))
    print(f"[22/22] c image noise: {json.dumps(out)}", flush=True)
    if len(est) < NOISE_MIN_TRACKED * NOISE_FRAMES:
        raise AssertionError(f"phase 22c: tracked {len(est)} of {NOISE_FRAMES} noisy frames")
    if not ate < NOISE_MAX_ATE * path:
        raise AssertionError(f"phase 22c: noisy ATE {ate:.4f} m ≥ {NOISE_MAX_ATE} × {path:.2f} m")
    return launches, out


def _weak_run(cfg: SLAMConfig, frames, pipelined: bool, k=None) -> dict:
    """Phase 6's world with frame ``k`` forced weak (a local-map match bar no
    frame reaches, no keyframe) on the call that resolves it — call k
    synchronous, k + 1 pipelined — so the reference-keyframe fallback
    recovers it; the mapping tail inside each insertion, so nothing else
    replaces the local map (``tests/test_torch_pipelined.py``).  Without
    ``k`` the synchronous run takes the first frame ≥ 3 after
    WEAK_MIN_KEYFRAMES keyframes.  The weak call is traced: each kernel once
    a frame-program run, the pipelined re-dispatch one more run.  Records
    every frame-program dispatch: (frame, local map in, local map out,
    velocity in, replays, captures)."""
    mode = "pipelined" if pipelined else "sync"
    cfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking, pipelined=pipelined),
                      mapping=dataclasses.replace(cfg.mapping, synchronous=True))
    weak_cfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking, min_localmap_matches=10 ** 6))
    slam = SLAM(cfg, enable_loop_closing=False, device="cuda")
    dispatches = []
    run_frame = slam._run_frame

    def spy(img_l, img_r, last, velocity, local, wide):
        r0, c0 = _graph_counts(slam)
        out = run_frame(img_l, img_r, last, velocity, local, wide)
        r1, c1 = _graph_counts(slam)
        dispatches.append(dict(fid=slam.frame_id - 1, local_in=local, local_out=out[3], velocity=velocity,
                               replays=r1 - r0, captures=c1 - c0))
        return out

    slam._run_frame = spy
    need_keyframe = slam._need_keyframe
    torch.cuda.synchronize()
    _reset_launches()
    weak_call, weak_stats, records = None if k is None else k + pipelined, None, []
    for i, (img_l, img_r, _) in enumerate(frames):
        if k is None and i >= 3 and slam._n_kf >= WEAK_MIN_KEYFRAMES:
            k = weak_call = i
        weak = i == weak_call
        if weak and slam._n_kf < WEAK_MIN_KEYFRAMES:
            raise AssertionError(f"phase 22d {mode}: {slam._n_kf} keyframes before the weak frame {k}")
        slam.cfg = weak_cfg if weak else cfg
        slam._need_keyframe = (lambda *a, **kw: False) if weak else need_keyframe
        # the fallback reads its match counts back by design (outside the
        # frame program); every other tracked frame runs without host syncs
        slam.frame_sync_debug_mode = "error" if i >= 2 and not weak else None
        pose, stats, ms = _track(slam, f"weak {mode} {i}", img_l, img_r, profile=weak)
        fill = pipelined and stats.get("pipeline_fill")
        if slam.state != TrackState.OK or (pose is None and not fill):
            raise AssertionError(f"phase 22d {mode} frame {i}: state {slam.state}, stats {stats}")
        if weak:
            weak_stats = stats
        rec = dict(frame=i, ms=ms, weak=weak, n_kf=slam._n_kf, n_inliers=stats.get("n_inliers"),
                   n_localmap_matches=stats.get("n_localmap_matches"), ref_fallback=stats.get("ref_fallback", 0))
        print(f"[22/22] d {mode} frame {i}: {json.dumps(rec)}", flush=True)
        records.append(rec)
    slam.cfg, slam._need_keyframe = cfg, need_keyframe
    slam.flush()
    torch.cuda.synchronize()
    slam.frame_sync_debug_mode = None
    return dict(slam=slam, k=k, weak_call=weak_call, weak_stats=weak_stats, records=records,
                dispatches=dispatches, launches=_launches())


def run_weak_frame(map_cfg: SLAMConfig) -> tuple:
    """22d: a forced weak frame over phase 6's world, synchronous and
    pipelined, on the graph.  Gates: the weak frame recovered by the
    reference-keyframe fallback within WEAK_MAX_ERR_M of the truth, every
    frame OK; pipelined, its successor re-dispatched as a replay with no
    capture on the local map the weak frame was dispatched with (the
    speculative dispatch on the weak frame's snapshot), and the trajectory
    within the CPU test's tolerance of the synchronous one.  Returns
    (launch counts of both runs, summary)."""
    ds = SyntheticStereoDataset(map_cfg.camera, n_frames=MAP_FRAMES + 2, speed=MAP_SPEED,
                                box_scale=2.5, sky=True, device="cuda")
    frames = [ds.frame(i) for i in range(WEAK_FRAMES)]  # rendered on the card, set-up
    gt = {i: g for i, (_, _, g) in enumerate(frames)}
    sync = _weak_run(map_cfg, frames, False)
    k = sync["k"]
    if k is None:
        raise AssertionError(f"phase 22d: fewer than {WEAK_MIN_KEYFRAMES} keyframes in {WEAK_FRAMES} frames")
    pipe = _weak_run(map_cfg, frames, True, k)
    out, problems = dict(weak_frame=k), []
    for mode, run in (("sync", sync), ("pipelined", pipe)):
        slam, st = run["slam"], run["weak_stats"]
        traj = dict(slam.trajectory)
        recoveries = sum(r["ref_fallback"] for r in run["records"])
        err = _trans_err(traj[k], gt[k]) if k in traj else float("inf")
        d_k = [d for d in run["dispatches"] if d["fid"] == k]
        d_next = [d for d in run["dispatches"] if d["fid"] == k + 1]
        out[mode] = dict(weak_call=run["weak_call"], ref_fallback=st.get("ref_fallback"),
                         weak_frame_recoveries=recoveries, n_inliers=st.get("n_inliers"),
                         trans_err_m=err, frames_in_trajectory=len(traj), n_keyframes=slam.n_keyframes,
                         dispatches_of_next=[dict(replays=d["replays"], captures=d["captures"]) for d in d_next],
                         captures=_captures(slam), launches=run["launches"])
        if st.get("ref_fallback") != 1 or recoveries < 1:
            problems.append(f"{mode}: frame {k} was not recovered by the fallback: {st}")
        if not err <= WEAK_MAX_ERR_M:
            problems.append(f"{mode}: frame {k} {err:.4f} m from the truth")
        if sorted(traj) != list(range(WEAK_FRAMES)):
            problems.append(f"{mode}: trajectory holds frames {sorted(traj)}")
        if not d_k or not d_next:
            problems.append(f"{mode}: no dispatch of frame {k} or {k + 1}")
            continue
        if mode == "sync":
            if d_next[0]["local_in"] is not d_k[-1]["local_in"]:
                problems.append("sync: frame k + 1 was not tracked against frame k's local map")
        else:
            spec, redo = d_next[0], d_next[-1]
            if len(d_next) != 2:
                problems.append(f"pipelined: frame {k + 1} dispatched {len(d_next)} times, want 2")
            if spec["local_in"] is not d_k[-1]["local_out"]:
                problems.append("pipelined: the speculative dispatch was not on the weak frame's snapshot")
            if redo["local_in"] is not d_k[-1]["local_in"]:
                problems.append("pipelined: the re-dispatch did not take the weak frame's dispatch local map")
            if (redo["replays"], redo["captures"]) != (1, 0):
                problems.append(f"pipelined: the re-dispatch ran {redo['replays']} replay(s), "
                                f"{redo['captures']} capture(s), want one replay")
    Ts, Tp = (torch.from_numpy(np.stack([T for _, T in sorted(r["slam"].trajectory)])) for r in (sync, pipe))
    gap_m, gap_deg = _pose_diff(Ts, Tp)
    out["pipelined_vs_sync"] = dict(max_m=gap_m, max_deg=gap_deg)
    if gap_m > WEAK_POSE_TOL_M or gap_deg > WEAK_POSE_TOL_DEG:
        problems.append(f"pipelined poses left the synchronous ones by {gap_m:.4f} m, {gap_deg:.4f}°")
    print(f"[22/22] d forced weak frame: {json.dumps(out, default=str)}", flush=True)
    if problems:
        raise AssertionError(f"phase 22d: {problems}")
    return [sync["launches"], pipe["launches"]], out


def run_dryrun_one() -> dict:
    """22e: ``entry.dryrun_multichip(1)`` with no devices named, what JAX's
    entry calls on a one-chip machine: it must run on the card."""
    from orb_slam2_ros2_tpu_torch import entry
    from orb_slam2_ros2_tpu_torch.parallel.mesh import local_devices

    devs = [str(d) for d in local_devices()]
    out = entry.dryrun_multichip(1)
    res = dict(local_devices=devs, **{k: out[k] for k in ("device", "gba_ms", "gba_1shard_ms", "gba_pose_diff_m",
                                                           "pg_ms", "pg_1shard_ms", "pg_diff")})
    print(f"[22/22] e dryrun_multichip(1): {json.dumps(res)}", flush=True)
    if not res["device"].startswith("cuda") or not all(d.startswith("cuda") for d in devs):
        raise AssertionError(f"phase 22e: the dry run chose {res['device']}, local devices {devs}")
    return res


def run_phase22(base: SLAMConfig, map_cfg: SLAMConfig) -> list:
    """Phase 22: the lens-distortion path (a, b), image noise (c), a forced
    weak frame synchronous and pipelined (d) and the one-slot dry run (e).
    Returns the launch counts of its runs."""
    t0 = time.perf_counter()
    dist_launches, dist = run_distorted()
    noise_launches, noise = run_noise(base)
    weak_launches, weak = run_weak_frame(map_cfg)
    dry = run_dryrun_one()
    runs = [*dist_launches, noise_launches, *weak_launches]
    summary = dict(seconds=time.perf_counter() - t0,
                   a=dict(ate_pinhole_m=dist["ate_pinhole_m"], ate_distorted_m=dist["ate_distorted_m"],
                          frame_ms_pinhole=dist["frame_ms_pinhole"], frame_ms_distorted=dist["frame_ms_distorted"],
                          replay_device_ms=dist["replay_device_ms"],
                          undistort_graph_ms=dist["undistort_graph_ms"]),
                   b=dist["cli_tum"], c=dict(tracked=noise["tracked"], ate_m=noise["ate_m"],
                                             median_inliers=noise["median_inliers"]),
                   d=dict(weak_frame=weak["weak_frame"], pipelined_vs_sync=weak["pipelined_vs_sync"]),
                   e=dict(device=dry["device"]),
                   launches={n: sum(x[n] for x in runs) for n in (*KERNELS, "replays")})
    print(f"[22/22] distortion, noise, weak frame, dry run: {json.dumps(summary)}", flush=True)
    return runs


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
    print(f"[1/22] device: {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"[2/22] build: {build_s:.3f} s total, nvcc {json.dumps(_build.build_seconds)}", flush=True)
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
    print(f"[3/22] fast_nms: one launch over the canvas {tuple(k1_canvas.shape)} and one per "
          f"level, bit-equal to nms3(fast_score) on {len(levels)} levels "
          f"{[tuple(x.shape) for x in levels]}, nms on and off", flush=True)
    canvas, centers = k2_inputs(cfg, gen)
    k2_err = k2_check(canvas, centers)
    print(f"[4/22] patches: bit-equal to extract_patches_plain, canvas {tuple(canvas.shape)}, "
          f"{centers.shape[0]} centres", flush=True)
    k3_p, k3_ang, k3_bins, k3_tab = k3_inputs(canvas, centers)
    k3_D = brief.pair_matrix("cuda")
    k3_bits = k3_check(k3_p, k3_ang, k3_tab, k3_D)
    print(f"[4/22] brief: against describe_plain on phase 4's {k3_p.shape[0]} patches, {k3_bits} of "
          f"{k3_p.shape[0] * brief.N_PAIRS} bits differ, each at a dense score within 1e-4 of zero", flush=True)

    records, launches, med = run_slice(cfg)
    print(f"[5/22] localization: {N_FRAMES} frames OK, median n_inliers(1-9) {med}, "
          f"max trans err {max(r['trans_err_m'] for r in records):.4f} m, launches {launches}",
          flush=True)
    map_records, map_launches, summary, map_slam, map_frames = run_mapping(map_cfg)
    map_summary = summary
    print(f"[6/22] mapping: {MAP_FRAMES} frames OK, {summary['new_keyframes']} keyframes after "
          f"keyframe 0, {summary['local_ba_runs']} local BAs, ATE live {summary['ate_live_m']:.4f} m "
          f"final {summary['ate_final_m']:.4f} m on a {summary['path_len_m']:.2f} m path, "
          f"launches {map_launches}", flush=True)

    map_poses = [p for _, p in map_slam.trajectory]
    map_summary.update(frame_ms_keyframe=_frame_ms(map_records, True), frame_ms_other=_frame_ms(map_records, False))
    reloc_cfg = map_cfg.replace(tracking=dataclasses.replace(map_cfg.tracking, only_tracking=True))
    with _RelocCalls("7") as reloc7:
        reloc_records, reloc_launches, reloc = run_relocalization(map_slam, reloc_cfg, map_frames)
    print(f"[7/22] relocalization: {json.dumps(reloc)}, launches {reloc_launches}", flush=True)
    del map_slam, map_frames

    rgbd_cfg = rgbd_config(base)
    r_levels, r_canvas, r_table = k1_inputs(rgbd_cfg, gen, batch=1)
    k1_err = max(k1_err, k1_check(r_levels, r_canvas, r_table))
    r2_canvas, r2_centers = k2_inputs(rgbd_cfg, gen, batch=1)
    k2_err = max(k2_err, k2_check(r2_canvas, r2_centers))
    print(f"[8/22] RGB-D kernels: fast_nms bit-equal on the one-image canvas {tuple(r_canvas.shape)} "
          f"(one launch, and per level, nms on and off), patches bit-equal with "
          f"{r2_centers.shape[0]} centres", flush=True)
    rgbd_records, rgbd_launches, rgbd = run_rgbd(rgbd_cfg)
    print(f"[8/22] RGB-D: {RGBD_FRAMES} frames OK, {json.dumps(rgbd)}, launches {rgbd_launches}",
          flush=True)

    with _EssentialCalls() as spied, _GBACalls() as gba9, _LoopCalls() as loop9:
        _, loop_launches, loop = run_loop(base)
    print(f"[9/22] loop closing: {loop['frames']} frames OK, closure at frame {loop['closure_frame']} "
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
    k3_ms = device_ms(lambda: brief.describe_kernel(k3_p, k3_bins, k3_tab))
    k3_plain = device_ms(lambda: brief.describe_plain(k3_p, k3_ang, k3_D), runs=20, queue_ahead=False)
    k3_flat = k3_p.reshape(k3_p.shape[0], -1).to(torch.bfloat16).float()
    k3_scores = torch.empty((k3_p.shape[0], k3_D.shape[1]), dtype=torch.float32, device="cuda")
    k3_lib = device_ms(lambda: torch.matmul(k3_flat, k3_D, out=k3_scores), runs=20)
    k3_bound, k3_by = k3_bound_ms(k3_p)
    print(f"[10/22] localization frame ms (frames 2-{N_FRAMES - 1}): median {_frame_ms(records):.3f}, "
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
    print(f"[10/22] relocalization ms: save {reloc['save_ms']:.1f}, load (with rebuild) "
          f"{reloc['load_ms']:.1f}, rebuild alone {reloc['rebuild_ms']:.1f} "
          f"({reloc['kf_capacity']} slots, {reloc['n_words']} words), relocalizing frames "
          f"{[round(x, 1) for x in reloc['reloc_ms']]}, LOST frames "
          f"{[round(x, 1) for x in reloc['lost_ms']]}, tracked frames median "
          f"{reloc['track_ms_median']:.1f} | RGB-D frame ms (frames ≥ 2): keyframe median "
          f"{_frame_ms(rgbd_records, True):.3f}, other median {_frame_ms(rgbd_records, False):.3f} | "
          f"device ms on the RGB-D canvas: fast_nms {k1_rgbd_ms:.5f} (bound "
          f"{k1_bound_ms(r_table)[0] * 1e3:.3f} us), patches {k2_rgbd_ms:.5f}", flush=True)
    print(f"[10/22] device ms per call ({TIMED_RUNS} back-to-back): fast_nms (8 levels x 2 images, "
          f"one launch) {k1_ms:.5f} (per-level design {K1_OLD_MS}) vs plain {k1_plain:.4f}, bound "
          f"{k1_bound * 1e3:.3f} us ({k1_by}), share {k1_bound / k1_ms:.3f} | patches {k2_ms:.5f} "
          f"(before {K2_OLD_MS}) vs plain {k2_plain:.4f}, library canvas[rows, cols] {k2_lib:.5f}, "
          f"bound {k2_bound * 1e3:.3f} us ({k2_by}), share {k2_bound / k2_ms:.3f} | brief "
          f"({k3_p.shape[0]} patches) {k3_ms:.5f} vs plain {k3_plain:.4f}, library (the f32 GEMM) "
          f"{k3_lib:.4f}, bound {k3_bound * 1e3:.3f} us ({k3_by}), share {k3_bound / k3_ms:.3f}", flush=True)

    pair_launches, pair = run_graph_vs_eager(cfg)
    print(f"[11/22] graph vs eager, localization: {N_FRAMES} frames bit-equal (poses, stats vectors, "
          f"local maps, map), {pair['captures']} capture; frame ms median eager "
          f"{pair['eager_ms_median']:.3f} graph {pair['graph_ms_median']:.3f}; one frame profiled: "
          f"{json.dumps(pair['profile'])}, launches {pair_launches}", flush=True)
    (eager_map_launches, pipe_launches), pipe = run_pipelined_vs_sync(map_cfg, map_summary, map_records)
    print(f"[11/22] mapping eager / graph / pipelined: {json.dumps(pipe)}, launches eager "
          f"{eager_map_launches} pipelined {pipe_launches}", flush=True)
    _, pipe_loop_launches, pipe_loop = run_loop(
        base.replace(tracking=dataclasses.replace(base.tracking, pipelined=True)), tag="11/22")
    print(f"[11/22] loop closing pipelined: {pipe_loop['frames']} frames in order, closure at call "
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
    print(f"[11/22] pipelined blackout: {json.dumps(blackout)}, launches {blackout_launches}", flush=True)
    print(f"[11/22] relocalization (batched cascade) profiled: {json.dumps(reloc['reloc_profile'])}; "
          f"relocalizing frames {[round(x, 1) for x in reloc['reloc_ms']]} ms, inliers "
          f"{[r['n_inliers'] for r in reloc_records if r['kind'] == 'reloc']}, errors "
          f"{[round(r['trans_err_m'], 4) for r in reloc_records if r['kind'] == 'reloc']} m", flush=True)

    probe = probe_shell()
    print(f"[12/22] probe: {json.dumps(probe)}", flush=True)
    shell_launches, shell = run_shell(base, probe)
    ran = [p for p in shell if p["ran"]]
    summary = {p["part"]: {k: p.get(k) for k in ("tracked", "frame_ms_median", "frame_ms_p90", "fps",
                                                  "save_ms", "load_ms", "saved_bytes", "decoded")}
               for p in ran}
    print(f"[12/22] shell: {len(ran)} parts passed, not run: "
          f"{[p['part'] + ' (' + p['why'] + ')' for p in shell if not p['ran']]}; {json.dumps(summary)}",
          flush=True)

    multi_launches, multi = run_multi_device(base, map_cfg, loop, map_summary, map_poses)
    print(f"[13/22] multi-device done at {time.perf_counter() - t_start:.1f} s", flush=True)

    long_launches, scale, reloc14 = run_long(base)
    remaining_launches = run_remaining(base, map_cfg, gen)
    graph_launches = run_graph_phase(map_cfg, base, spied, loop, scale)
    run_gba_reloc_phase(base, gba9, reloc7.calls + reloc14,
                        {"7": reloc["reloc_ms"], "14a": scale["kidnap_ms"]}, scale)
    run_loop_phase(base, loop9, loop, scale)
    mesh_launches = run_mesh_graphs(base, multi)
    del multi
    tool_launches = run_tools()
    bench_launches = run_benches()
    phase22_launches = run_phase22(base, map_cfg)

    runs_launches = (launches, map_launches, reloc_launches, rgbd_launches, loop_launches,
                     pair_launches, eager_map_launches, pipe_launches, pipe_loop_launches,
                     blackout_launches, *shell_launches, *multi_launches, *long_launches,
                     *remaining_launches, *graph_launches, *mesh_launches, tool_launches, bench_launches,
                     *phase22_launches)
    # launches: the wrappers' own (eager frames, first frames of graphs,
    # frontends of frames without a frame program) plus one a replay of a
    # frame graph — every run that replays had one of its replays traced by
    # the profiler, with each kernel once inside it — plus the runs inside
    # the tools' and the benches' graph replays (phases 20 and 21, counted per
    # kernel)
    replays = sum(x["replays"] for x in runs_launches)
    # K3 describes every patch gather of the main path: only the tools' stage
    # timings stop at the patches or the angles
    uneven = [x for x in runs_launches if x is not tool_launches and x["brief"] != x["patches"]]
    if uneven:
        raise AssertionError(f"runs whose K3 and K2 wrapper launches differ: {uneven}")
    counts = {}
    for name in KERNELS:
        eager = sum(x[name] for x in runs_launches)
        in_graphs = replays + sum(x.get(f"graph_{name}", 0) for x in runs_launches)
        counts[name] = dict(launches=eager + in_graphs, launches_by_wrapper=eager,
                            launches_in_graph_replays=in_graphs,
                            launches_in_tools=tool_launches[name] + tool_launches[f"graph_{name}"],
                            launches_in_benches=bench_launches[name] + bench_launches[f"graph_{name}"],
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
        {"name": "brief", "route": "cuda", "source": "orb_slam2_ros2_tpu_torch/csrc/brief.cu",
         "replaces": None, **counts["brief"], "bits_differing": k3_bits, "ms": k3_ms,
         "plain_ms": k3_plain, "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": k3_lib,
         "bound_us": k3_bound * 1e3, "share": k3_bound / k3_ms},
    ]
    print(f"[done] total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
