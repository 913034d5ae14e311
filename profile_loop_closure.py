#!/usr/bin/env python3
"""Where a loop closure's time goes, on one NVIDIA GPU.

    python3 profile_loop_closure.py

Runs ``chip_smoke.py``'s loop-closing phase (the circle world at the
default ``SLAMConfig()``, gates included) and keeps the inputs of the
closure's correction and of the background GBA.  Then, with
``torch.profiler`` (CPU + CUDA activities) around one call each, it prints
for the three parts of ``LoopCloser.correct`` (``correct_group``; the
matched-point attach with the loop-group fuses; ``optimize_essential``), an
ungated and a gated eager GBA chunk (``step_global_ba``, the program the
system's ``GBAGraphs`` captures) and the eager commit, on the map the
system's commit wrote (the same work): the host wall time untraced
and traced, kernel launches and memory copies, summed kernel time, the
device's idle share of the traced wall time and the top kernels
(``profile_reloc.traced``).  The parts of ``correct`` run eagerly here:
the system replays the front and the fuses as ``loop_closing.LoopGraphs``
(``chip_smoke.py`` phase 18 times those replays).  Needs nvcc and a CUDA
device; exits non-zero without one.
"""

from __future__ import annotations

import sys
from functools import partial

import numpy as np
import torch

import chip_smoke
from orb_slam2_ros2_tpu_torch import SLAMConfig
from orb_slam2_ros2_tpu_torch.ops import _build
from orb_slam2_ros2_tpu_torch.pipeline import loop_closing
from orb_slam2_ros2_tpu_torch.pipeline.frame_graph import tree_map
from orb_slam2_ros2_tpu_torch.pipeline import system as slam_system
from orb_slam2_ros2_tpu_torch.solvers.global_ba import GBAGraphs, step_global_ba
from orb_slam2_ros2_tpu_torch.solvers.pose_graph import optimize_pose_graph
from profile_reloc import timed, traced


def capture(owner, name: str, store: dict, keep=lambda args: True, before: bool = False):
    """Wrap ``owner.name`` so that each call's arguments and result land in
    ``store[name]`` (the last call that ``keep`` accepts); with ``before``
    the arguments as they were before the call, cloned (a call that writes
    into the map it is given)."""
    fn = getattr(owner, name)

    def wrapped(*args, **kwargs):
        kept = tree_map(torch.clone, args) if before and keep(args) else args
        out = fn(*args, **kwargs)
        if keep(args):
            store[name] = (kept, kwargs, out)
        return out

    setattr(owner, name, wrapped)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_loop_closure: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    print(chip_smoke.gpu_line(), flush=True)
    _build.build_all()
    cfg = SLAMConfig()
    seen: dict = {}
    # the real closure, not the warm-up's keyframe 0 against itself
    capture(loop_closing.LoopCloser, "correct", seen, keep=lambda a: a[3] != a[4], before=True)
    capture(slam_system, "start_global_ba", seen)
    capture(GBAGraphs, "commit", seen)
    chip_smoke.run_loop(cfg)
    for name in ("correct", "start_global_ba", "commit"):
        if name not in seen:
            raise AssertionError(f"the loop phase made no {name} call to profile")

    (closer, state, cam, kf_cur, kf_cand, S12, matched, group), _, _ = seen["correct"]
    mw = cfg.mapping.min_covis_weight
    geom = closer._geom

    def fuses(st):
        st = loop_closing.attach_matched_mps(st, kf_cur, matched)
        w = st.covis[kf_cur].cpu().numpy()
        ids = np.argsort(-w)[:16]
        return loop_closing.fuse_group_into_kfs(st, cam, group, ids[w[ids] >= mw].tolist(), **geom)

    pre_conn = state.covis > 0
    s1, S_nc, gmask = loop_closing.correct_group(state, kf_cur, kf_cand, S12, min_covis_weight=mw)
    s2 = fuses(s1)
    essential = partial(loop_closing.optimize_essential, s2, kf_cur, kf_cand, S12, S_nc, gmask, pre_conn,
                        essential_weight=cfg.loop.essential_graph_weight,
                        pose_graph_fn=partial(optimize_pose_graph, iters=20))
    b, lp = cfg.ba, cfg.loop
    phase1 = lp.global_ba_phase_iters[0]
    (_, _, pending) = seen["start_global_ba"]
    (_, live, done), _, _ = seen["commit"]
    chunk = partial(step_global_ba, cam=cam, n_iters=1, pcg_iters=b.pcg_iters, chi2_mono=b.chi2_mono,
                    chi2_stereo=b.chi2_stereo, robust_after=phase1)
    calls = [
        ("correct_group", lambda: loop_closing.correct_group(state, kf_cur, kf_cand, S12, min_covis_weight=mw)),
        ("attach + loop-group fuses", lambda: fuses(s1)),
        ("optimize_essential (PCG route)", essential),
        ("GBA chunk, ungated", lambda: chunk(pending)),
        ("GBA chunk, gated", lambda: chunk(pending._replace(chunks_done=phase1))),
        ("GBA commit", lambda: slam_system.commit_global_ba(live, done)),
    ]
    for name, fn in calls:
        _, ms = timed(fn)
        traced(name, fn, ms)
    print(chip_smoke.gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
