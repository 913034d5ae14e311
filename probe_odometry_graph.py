#!/usr/bin/env python3
"""What a captured odometry step holds, and what the profiler records of its
replays, on one NVIDIA GPU.

    python3 probe_odometry_graph.py [--captures 4] [--traces 8]

Builds the fused odometry step of ``chip_smoke.py`` phase 15b (the default
``SLAMConfig()``, the KITTI-like forward world at 0.35 m/frame) and captures
it ``--captures`` times, each time as a new ``StepGraph`` whose CUDA graph is
kept for ``debug_dump``.  For each capture it counts the graph's nodes and
the ones that run K1 (``fast_nms_kernel``) and K2 (``patches_kernel``) from
the dump, then replays it ``--traces`` times, each replay under a profiler
session of its own (``torch.profiler``, CPU + CUDA activities), and counts
the K1 and K2 records, every kernel record and the graph launches each
session saw; every replay's outputs are held to the eager step's on the
same inputs.  Prints one JSON line per capture, then a summary line: the
sessions that missed K1 or K2, by trace index, and the kernel records of
those sessions against the graph's kernel nodes.  The first capture's DOT
dump is written to ``chiprun_out/odometry_graph_0.dot``.  Needs nvcc and a CUDA
device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from orb_slam2_ros2_tpu_torch import SLAMConfig
from orb_slam2_ros2_tpu_torch.features import make_stereo_frontend
from orb_slam2_ros2_tpu_torch.geometry.camera import CameraParams
from orb_slam2_ros2_tpu_torch.io.synthetic import SyntheticStereoDataset
from orb_slam2_ros2_tpu_torch.ops import _build
from orb_slam2_ros2_tpu_torch.pipeline import tracking as tr


def traced(fn):
    """``fn()`` under one profiler session: its result, the device's kernel
    records by name and the graph launches."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kernels, graph_launches = collections.Counter(), 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.name.lower().startswith(("memcpy", "memset")):
            kernels[e.name] += 1
        elif e.name.startswith("cudaGraphLaunch"):
            graph_launches += 1
    return out, kernels, graph_launches


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--captures", type=int, default=4)
    p.add_argument("--traces", type=int, default=8)
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("probe_odometry_graph: no CUDA device", file=sys.stderr)
        return 1
    print(cs.gpu_line(), flush=True)
    _build.build_all()
    cfg = SLAMConfig()
    ds = SyntheticStereoDataset(cfg.camera, n_frames=a.traces + 3, speed=cs.SPEED, device="cuda")
    frames = [ds.frame(i) for i in range(a.traces + 3)]
    cam = CameraParams.from_config(cfg.camera, "cuda")
    fe = make_stereo_frontend(cfg, "cuda")
    eye = torch.eye(4, dtype=torch.float32, device="cuda")
    sf0 = fe(frames[0][0], frames[0][1], cam)
    pw, has = tr.unproject_frame(cam, sf0, eye)
    state0 = (tr.TrackedFrame(sf0, eye, pw, has), eye)

    missed, summary = [], collections.Counter()
    for c in range(a.captures):
        step = tr.make_fused_odometry_step(cfg, "cuda")
        with cs.debug_graphs():
            state = step(cam, frames[1][0], frames[1][1], *state0)[:2]
        graph = next(iter(step._graphs.values())).graph
        nodes = cs.graph_kernel_nodes(graph)
        if c == 0:
            os.makedirs("chiprun_out", exist_ok=True)
            graph.debug_dump("chiprun_out/odometry_graph_0.dot")
        runs = []
        for t in range(a.traces):
            l, r, _ = frames[t + 2]
            want = step.program(cam, l, r, *state)
            out, kernels, graph_launches = traced(lambda: step(cam, l, r, *state))
            k1 = sum(n for k, n in kernels.items() if "fast_nms_kernel" in k)
            k2 = sum(n for k, n in kernels.items() if "patches_kernel" in k)
            run = dict(trace=t, k1=k1, k2=k2, kernel_records=sum(kernels.values()),
                       graph_launches=graph_launches, equals_eager=cs._equal_trees(want, out))
            runs.append(run)
            summary["sessions"] += 1
            summary["k1_seen"] += k1 == 1
            summary["k2_seen"] += k2 == 1
            summary["equal"] += run["equals_eager"]
            if (k1, k2) != (1, 1):
                missed.append(dict(run, capture=c, kernel_nodes=nodes,
                                   names=sorted(k for k in kernels if "kernel" in k.lower())[:40]))
            state = out[:2]
        print(json.dumps(dict(capture=c, graph_nodes=nodes, traces=runs)), flush=True)
    print(json.dumps(dict(summary=dict(summary), missed=missed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
