"""Timing helpers: the card's line (a copy of ``tools/_timing.gpu_line``),
percentiles, CUDA-event spans, and the reduction of a ``torch.profiler``
trace of the card's activity to a kernel table, the device's busy time and
its idle gaps labelled by the benchmark's own host spans."""

from __future__ import annotations

import subprocess

import numpy as np
import torch

def gpu_line() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def percentile(values, q: float):
    """The q-th percentile (numpy's linear interpolation), None if empty."""
    return float(np.percentile(np.asarray(values, np.float64), q)) if len(values) else None


class EventSpans:
    """CUDA-event pairs recorded around calls on the current stream; ``ms()``
    after a synchronise."""

    def __init__(self):
        self.pairs = []

    def wrap(self, fn):
        def timed(*args, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.pairs.append((start, end))
            return out
        return timed

    def ms(self, first: int = 0) -> list:
        return [s.elapsed_time(e) for s, e in self.pairs[first:]]


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


MARKER = "spin_kernel"          # torch.cuda._sleep's kernel: the slice's edges


def _events(prof):
    """(on the device, name, start µs, end µs) of each event the profiler
    recorded: from its raw results where it has them (fast), else from
    ``prof.events()``."""
    from torch.autograd import DeviceType

    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is not None:
        return [(e.device_type() == DeviceType.CUDA, e.name(), e.start_ns() / 1e3,
                 (e.start_ns() + e.duration_ns()) / 1e3) for e in raw.events()]
    return [(e.device_type == DeviceType.CUDA, e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()]


def reduce_trace(prof, marks_ns: list, spans: list, top: int = 10) -> dict:
    """From a profiler that recorded the card's activity, over the slice
    between the two marker kernels (``MARKER``): the device's kernels by
    name (calls, total µs), its busy seconds (the union of kernels, copies
    and sets), the top device operations, and the longest idle gaps, each
    labelled by the host span (``spans``: (start ns, end ns, name) on the
    host's ``perf_counter_ns`` clock) that the host was in at the gap's
    middle.  The host's clock is put on the trace's by the first marker's
    launch (the runtime's ``cudaLaunchKernel`` at ``marks_ns[0]``); where
    the trace holds no runtime call, a gap is labelled by the device
    operation that ends it."""
    dev_events, launches = [], []
    for on_device, name, a, b in _events(prof):
        if on_device:
            dev_events.append((a, b, name))
        elif name == "cudaLaunchKernel":
            launches.append(a)
    marks = sorted((s, t) for s, t, name in dev_events if MARKER in name)
    if len(marks) < 2:
        raise RuntimeError(f"the trace holds {len(marks)} of the slice's two marker kernels")
    t0_us, t1_us = marks[0][0], marks[-1][1]
    kernels, busy = {}, []
    for s, t, name in dev_events:
        if t <= t0_us or s >= t1_us or MARKER in name:
            continue
        busy.append((max(s, t0_us), min(t, t1_us)))
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += t - s
    merged = _union(busy)
    busy_us = sum(e - s for s, e in merged)
    edges = [t0_us] + [v for se in merged for v in se] + [t1_us]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    starts = sorted((s, name) for s, _, name in dev_events if MARKER not in name)
    host = None
    if launches:
        base = min(launches) - marks_ns[0] / 1e3
        host = [((a / 1e3) + base, (b / 1e3) + base, name) for a, b, name in spans]

    def label(s, e):
        if host is not None:
            mid = 0.5 * (s + e)
            inside = [(b - a, name) for a, b, name in host if a <= mid <= b]
            return min(inside)[1] if inside else "between_calls"
        after = [name for t, name in starts if t >= e]
        return f"before {after[0]}" if after else "slice_end"

    ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    return {
        "kernels": {k: (n, us) for k, (n, us) in kernels.items()},
        "busy_s": busy_us / 1e6,
        "trace_window_s": (t1_us - t0_us) / 1e6,
        "device_ops": [[k, us / 1e6] for k, (_, us) in ops[:top]],
        "idle_gaps": [[label(s, e), (e - s) / 1e6] for s, e in gaps[:top]],
        "gap_labels": "host_spans" if host is not None else "next_device_op",
    }
