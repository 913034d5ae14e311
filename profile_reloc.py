#!/usr/bin/env python3
"""Where a relocalizing frame's time goes, on one NVIDIA GPU.

    python3 profile_reloc.py

Builds the map of ``chip_smoke.py``'s mapping phase (40 frames at the
default KITTI-size configuration), saves it and loads it into a
localization-mode ``SLAM`` as the relocalization phase does, then, with
``torch.profiler`` (CPU + CUDA activities) around one call each, prints for
``load`` (with the database rebuild), a relocalizing frame, a frame tracked
after it, a blank frame that loses track and a LOST frame that finds no
place: the host wall time untraced and traced, the number of kernel launches
and memory copies, the summed kernel time, the device's idle share of the
traced wall time, and the ten kernels with the most time.  The untraced
times come from a first pass over the same calls on a first load.

The two hand-written kernels are launched through ctypes; the profiler
counts them like any other kernel.  Needs nvcc and a CUDA device; exits
non-zero without one.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from orb_slam2_ros2_tpu_torch import SLAMConfig
from orb_slam2_ros2_tpu_torch.ops import _build
from orb_slam2_ros2_tpu_torch.pipeline.system import SLAM
from orb_slam2_ros2_tpu_torch.pipeline.tracking import TrackState


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1000.0


def traced(name: str, fn, untraced_ms: float):
    """Run ``fn`` under the profiler and print its counts."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out, wall_ms = timed(fn)
    kernels, copies, kernel_us = 0, 0, 0.0
    by_name = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if ev.name.lower().startswith("memcpy") or ev.name.lower().startswith("memset"):
            copies += 1
            continue
        kernels += 1
        kernel_us += ev.device_time
        n, us = by_name.get(ev.name, (0, 0.0))
        by_name[ev.name] = (n + 1, us + ev.device_time)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    print(json.dumps(dict(
        call=name, untraced_ms=untraced_ms, traced_ms=wall_ms, kernel_launches=kernels,
        memcpy_memset=copies, kernel_ms=kernel_us / 1000.0,
        device_idle_share_traced=1.0 - kernel_us / 1000.0 / wall_ms,
        top_kernels=[dict(name=k[:80], n=n, ms=us / 1000.0) for k, (n, us) in top])), flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_reloc: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    print(chip_smoke.gpu_line(), flush=True)
    _build.build_all()
    base = SLAMConfig()
    map_cfg = base.replace(tracking=dataclasses.replace(base.tracking, th_depth=chip_smoke.MAP_TH_DEPTH))
    cfg = map_cfg.replace(tracking=dataclasses.replace(map_cfg.tracking, only_tracking=True))
    _, _, _, map_slam, frames = chip_smoke.run_mapping(map_cfg)
    map_slam._ensure_loop_closer(map_slam.ref_kf)
    blank = torch.zeros_like(frames[0][0])
    # (name, images) in the order of chip_smoke's relocalization phase
    calls = [("reloc frame", frames[chip_smoke.RELOC_FRAME][:2]),
             ("tracked frame (wide search)", frames[chip_smoke.RELOC_FRAME + 1][:2]),
             ("tracked frame", frames[chip_smoke.RELOC_FRAME + 2][:2]),
             ("blank frame, loses track", (blank, blank)),
             ("LOST frame, no place found", (blank, blank)),
             ("reloc frame again", frames[chip_smoke.RELOC_AGAIN_FRAME][:2])]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "map")
        map_slam.save(path)
        first = SLAM(cfg, device="cuda")
        _, load_ms = timed(lambda: first.load(path))
        untraced = [timed(lambda im=im: first.track(*im))[1] for _, im in calls]
        slam = SLAM(cfg, device="cuda")
        traced("load (with rebuild)", lambda: slam.load(path), load_ms)
    for (name, im), ms in zip(calls, untraced):
        traced(name, lambda im=im: slam.track(*im), ms)
    if slam.state != TrackState.OK:
        raise AssertionError(f"the last frame did not relocalize: {slam.state}")
    print(chip_smoke.gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
