"""Timing helpers of the measurement tools: the port's counterpart of the
``scan_time`` / ``bench`` / ``bench_prog`` functions the repository's JAX
scripts copy from one another.

* ``scan_time`` — JAX's ``jax.lax.scan`` over T frames inside one jitted
  program: the body as a ``frame_graph.StepGraph``, captured once and
  replayed T times between one CUDA event pair, frame i copied into the
  static inputs inside the window; per-frame ms = span / T, the best of
  ``n_rep``.  The body's outputs are reduced to one f32 sum, as JAX's scan
  reduces them to keep them live.
* ``bench`` — JAX's ``jax.jit`` + ``block_until_ready`` + ``perf_counter``:
  the same program's replay timed by CUDA events, and the eager program
  beside it (the host's launches included).
* ``kernel_profile`` — ``torch.profiler`` over one call: kernels the device
  ran, their summed time, the top N by device time (the counterpart of
  ``jax.profiler``).

On ``--device cpu`` a ``StepGraph(capture=False)`` runs the program eagerly
behind the same static buffers, timed by ``perf_counter``: CPU times are
for the tests, not for ``PERF.md``.

Kernel launches: the wrappers of K1, K2 and K3 count what they launch
(``ops.fast.fast_nms_launches``, ``ops.patches.patch_launches``,
``ops.brief.brief_launches``); a CUDA graph's replay launches through the
graph, so ``Replay`` reads how many of each its program launched on its
eager first call and adds that to ``graph_kernels`` at every replay, and
``note_slam`` adds one of each for every frame-graph replay of a ``SLAM``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Callable, Optional

import torch

from ..ops import brief, fast, patches
from ..pipeline.frame_graph import StepGraph, tree_leaves

# K1, K2 and K3 runs inside CUDA-graph replays made by the tools since the
# last reset (a wrapper counts only what it launches itself)
graph_kernels = {"fast_nms": 0, "patches": 0, "brief": 0}


class Failed(SystemExit):
    """A tool's gate failed: exit code 1, raised after its lines are
    printed; ``result`` is what its ``main`` would have returned."""

    def __init__(self, result: dict):
        super().__init__(1)
        self.result = result


def reset_counts() -> None:
    """Zero ``graph_kernels`` (the wrappers' own counts are theirs to reset)."""
    for k in graph_kernels:
        graph_kernels[k] = 0


def wrapper_counts() -> dict:
    return {"fast_nms": fast.fast_nms_launches, "patches": patches.patch_launches,
            "brief": brief.brief_launches}


def note_slam(slam) -> None:
    """Add the K1, K2 and K3 runs of ``slam``'s frame-graph replays (one
    each a replay; the split's tracker graph likewise)."""
    g = slam._frame_graphs if slam._frame_graphs is not None else slam._track_graphs
    if g is not None:
        for k in graph_kernels:
            graph_kernels[k] += g.replays


def base_parser(prog: str, doc: Optional[str] = None) -> argparse.ArgumentParser:
    """A tool's parser with ``--device`` (default ``cuda``) and ``--config``."""
    ap = argparse.ArgumentParser(prog=f"orb_slam2_ros2_tpu_torch.tools.{prog}", description=doc)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; without a card pass --device cpu)")
    ap.add_argument("--config", default="", help="YAML config in place of SLAMConfig()")
    return ap


def load_config(path: str):
    from ..config import SLAMConfig

    return SLAMConfig.from_yaml(path) if path else SLAMConfig()


def resolve_device(name: str) -> torch.device:
    """The tool's device; a CUDA device without a card raises."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def gpu_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them; ``"cpu"`` on the CPU."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    lines = out.stdout.strip().splitlines()
    return lines[device.index or 0] if len(lines) > (device.index or 0) else lines[0]


def emit(tool: str, device: torch.device, result: dict) -> dict:
    """``result`` with the tool's name and the card, printed as one JSON line."""
    out = {"tool": tool, "device": str(device), "card": gpu_line(device), **result}
    print(json.dumps(out), flush=True)
    return out


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def release(device: torch.device) -> None:
    """Return the cached blocks of dropped graphs and tensors to the card."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def span_ms(fn: Callable, device: torch.device):
    """(ms, result) of one call of ``fn``: between two CUDA events, waited
    for, on the card (the host's dispatch inside), by the host's clock on
    the CPU."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end), out
    t0 = time.perf_counter()
    out = fn()
    return (time.perf_counter() - t0) * 1e3, out


def reduce_sum(out) -> torch.Tensor:
    """Every tensor of ``out`` summed into one f32 scalar (JAX's scan body's
    ``tree_reduce``)."""
    leaves = tree_leaves(out)
    total = leaves[0].float().sum()
    for t in leaves[1:]:
        total = total + t.float().sum()
    return total


class Replay:
    """``program`` as a ``StepGraph`` (captured on the card, eager behind
    the same static buffers on the CPU), or an existing ``StepGraph``;
    counts the K1, K2 and K3 runs of its replays into ``graph_kernels``."""

    def __init__(self, program, device: torch.device):
        self.step = program if isinstance(program, StepGraph) else StepGraph(
            program, capture=device.type == "cuda")
        self.per_replay: Optional[dict] = None

    def __call__(self, *args, fixed: tuple = ()):
        before = wrapper_counts()
        captures = self.step.captures
        out = self.step(*args, fixed=fixed)
        if self.step.captures > captures:   # the eager first call
            after = wrapper_counts()
            self.per_replay = {k: after[k] - before[k] for k in graph_kernels}
        elif self.step.capture:
            for k, n in self.per_replay.items():
                graph_kernels[k] += n
        return out


def scan_time(body: Callable, frames: list, device: torch.device, *, n_rep: int = 3) -> float:
    """Per-frame ms of ``body(*frames[i])`` over the T frames, replayed
    from one capture between one event pair (the frames copied in inside
    the window), the best of ``n_rep``; the outputs are reduced to one
    f32 sum."""
    step = Replay(lambda *x: reduce_sum(body(*x)), device)
    step(*frames[0])
    sync(device)
    best = float("inf")
    for _ in range(n_rep):
        ms, _ = span_ms(lambda: [step(*x) for x in frames], device)
        best = min(best, ms)
    return best / len(frames)


def bench(program: Callable, args: tuple, device: torch.device, *, fixed: tuple = (), reps: int = 3,
          restore: Optional[Callable] = None, eager: Optional[Callable] = None, graph: bool = True) -> dict:
    """``ms``: the best of ``reps`` replays of ``program(*args, *fixed)``
    (captured at a first, untimed call), each between one event pair;
    ``eager_ms``: the best of ``reps`` eager calls of ``eager`` (default the
    program) on the same arguments.  ``graph=False`` takes ``program`` as a
    call that replays a graph of its own (a ``KeyframeGraphs`` or
    ``LoopGraphs`` method), called as ``program(*args)``.  ``restore()``
    runs before every call, outside the window (a program that writes into
    storage gets it back as it was).  ``out`` is the last replay's result."""
    if graph:
        step = Replay(program, device)

        def call():
            return step(*args, fixed=fixed)
    else:
        def call():
            return program(*args)
    run_eager = eager if eager is not None else program

    def once(fn):
        if restore is not None:
            restore()
        sync(device)
        return span_ms(fn, device)

    once(call)
    ms, out = min((once(call) for _ in range(reps)), key=lambda r: r[0])
    eager_ms = min(once(lambda: run_eager(*args, *fixed))[0] for _ in range(reps))
    if restore is not None:
        restore()
    return {"ms": ms, "eager_ms": eager_ms, "out": out}


def kernel_profile(fn: Callable, device: torch.device, *, top: int = 20) -> dict:
    """``fn()`` once under ``torch.profiler``: the device's kernels (count,
    summed ms), graph launches, and every kernel name with its calls and
    total and mean device µs, the top ``top`` first; ``result`` is ``fn``'s."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    sync(device)
    with profile(activities=acts) as prof:
        result = fn()
        sync(device)
    rows, graph_launches = [], 0
    for e in prof.key_averages():
        if e.key.startswith("cudaGraphLaunch"):
            graph_launches += e.count
        if getattr(e, "device_type", None) == DeviceType.CUDA and not e.key.lower().startswith(
                ("memcpy", "memset")):
            us = float(getattr(e, "self_device_time_total", 0.0))
            rows.append({"name": e.key, "calls": int(e.count), "total_us": us,
                         "mean_us": us / max(int(e.count), 1)})
    rows.sort(key=lambda r: -r["total_us"])
    return {"kernels": sum(r["calls"] for r in rows), "kernel_ms": sum(r["total_us"] for r in rows) / 1e3,
            "graph_launches": graph_launches, "top": rows[:top], "rows": rows, "result": result}
