"""Per-stage time of the full SLAM host loop (port of the repository's
``profile_full.py``)::

    python3 -m orb_slam2_ros2_tpu_torch.tools.profile_full [--frames 60] [--warm 40]

Full SLAM (loop closing on) at ``SLAMConfig()`` on the default world at
0.8 m/frame: WARM frames, then N frames with ``SLAM.time_programs`` on (the
system's tracer, ``pipeline/trace.py``: nothing waits for a span).  Prints
fps over the N frames and, per stage, n / mean / median / max / total ms
and its share of the wall time: ``stages`` the device ms of the tracer's
device spans on the card (the frame graph's replay listed as ``track``,
the map-side programs by name), or on the CPU, which has no device clock,
the host ms of its host spans; ``host`` the host spans' ms on either
(``track`` a whole call, its ``upload``, ``dispatch``, ``fetch_wait``,
``decide`` and the programs inside); ``frame_total`` is
``SLAM.frame_times_ms``.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..pipeline.system import SLAM
from . import _frames, _timing


def stats_ms(values) -> dict:
    """n, mean, median, max and total of a list of ms."""
    a = np.asarray(values, np.float64)
    return {"n": int(a.size), "mean": float(a.mean()), "median": float(np.median(a)),
            "max": float(a.max()), "total": float(a.sum())}


def by_name(spans, since_ns: int, wall_ms: float, rename: Optional[dict] = None) -> dict:
    """``stats_ms`` and the share of ``wall_ms`` of the spans ([name, start
    ns, end ns, ...]) that start at ``since_ns`` or later, by name."""
    ms = {}
    for name, t0, t1, *_ in spans:
        if t0 >= since_ns:
            ms.setdefault((rename or {}).get(name, name), []).append((t1 - t0) / 1e6)
    out = {}
    for name, v in sorted(ms.items()):
        s = stats_ms(v)
        out[name] = {**s, "share": s["total"] / wall_ms}
    return out


def main(argv=None) -> dict:
    ap = _timing.base_parser("profile_full", __doc__)
    ap.add_argument("--frames", type=int, default=60, help="N profiled frames (JAX: 60)")
    ap.add_argument("--warm", type=int, default=40, help="frames before them (JAX: 40)")
    args = ap.parse_args(argv)
    dev = _timing.resolve_device(args.device)
    cfg = _timing.load_config(args.config)
    frames = _frames.render(cfg, args.frames + args.warm, dev)
    slam = SLAM(cfg, device=dev)
    tracked = sum(slam.track(il, ir)[0] is not None for il, ir in frames[:args.warm])
    slam.flush()
    warm_kfs = slam.n_keyframes

    slam.time_programs = True
    slam.frame_times_ms = []
    t0_ns = time.perf_counter_ns()
    t0 = time.perf_counter()
    tracked += sum(slam.track(il, ir)[0] is not None for il, ir in frames[args.warm:])
    slam.flush()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    _timing.note_slam(slam)

    wall_ms = dt * 1e3
    trace = slam.trace_export()
    host = by_name(trace["host"], t0_ns, wall_ms)
    stages = by_name(trace["device"], t0_ns, wall_ms, {"frame_graph": "track"}) if trace["device_clock"] else host
    out = {"frames": args.frames, "warm": args.warm, "tracked": tracked, "total_frames": len(frames),
           "warm_keyframes": warm_kfs, "keyframes": slam.n_keyframes, "loops_closed": slam.loops_closed,
           "wall_s": dt, "fps": args.frames / dt, "ms_per_frame": wall_ms / args.frames, "stages": stages,
           "host": host, "frame_total": stats_ms(slam.frame_times_ms)}
    del slam
    _timing.release(dev)
    return _timing.emit("profile_full", dev, out)


if __name__ == "__main__":
    main()
