"""Per-stage time of the full SLAM host loop (port of the repository's
``profile_full.py``)::

    python3 -m orb_slam2_ros2_tpu_torch.tools.profile_full [--frames 60] [--warm 40]

Full SLAM (loop closing on) at ``SLAMConfig()`` on the default world at
0.8 m/frame: WARM frames, then N frames with ``SLAM.profile`` on, which
times every stage (``frontend``, ``track``, ``bookkeep``, ``map_front``,
``map_tail``) between two CUDA events and waits for the second — a
synchronise a stage, so read the deltas more than the absolutes.  Prints
fps over the N frames and, per stage, n / mean / median / max / total ms
and its share of the wall time; ``frame_total`` is ``SLAM.frame_times_ms``.
"""

from __future__ import annotations

import time

import numpy as np

from ..pipeline.system import SLAM
from . import _frames, _timing


def stats_ms(values) -> dict:
    """n, mean, median, max and total of a list of ms."""
    a = np.asarray(values, np.float64)
    return {"n": int(a.size), "mean": float(a.mean()), "median": float(np.median(a)),
            "max": float(a.max()), "total": float(a.sum())}


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

    slam.profile = True
    slam.stage_times = {}
    slam.frame_times_ms = []
    t0 = time.perf_counter()
    tracked += sum(slam.track(il, ir)[0] is not None for il, ir in frames[args.warm:])
    slam.flush()
    dt = time.perf_counter() - t0
    _timing.note_slam(slam)

    wall_ms = dt * 1e3
    stages = {}
    for name, ts in sorted(slam.stage_times.items()):
        s = stats_ms([t * 1e3 for t in ts])
        stages[name] = {**s, "share": s["total"] / wall_ms}
    out = {"frames": args.frames, "warm": args.warm, "tracked": tracked, "total_frames": len(frames),
           "warm_keyframes": warm_kfs, "keyframes": slam.n_keyframes, "loops_closed": slam.loops_closed,
           "wall_s": dt, "fps": args.frames / dt, "ms_per_frame": wall_ms / args.frames, "stages": stages,
           "frame_total": stats_ms(slam.frame_times_ms)}
    del slam
    _timing.release(dev)
    return _timing.emit("profile_full", dev, out)


if __name__ == "__main__":
    main()
