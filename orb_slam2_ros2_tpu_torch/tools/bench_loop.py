"""The frame-time spike after a loop closure (port of the repository's
``bench_loop.py``)::

    python3 -m orb_slam2_ros2_tpu_torch.tools.bench_loop [--frames 100]

Full SLAM (loop closing on) at ``SLAMConfig()`` around the circle world
(N frames, ``box_scale=2.5``; the circle revisits after N−4 frames) for
two laps (``lap_frames``), recording the calls at which
``slam.loops_closed`` rises; then at most 36 extra frames while the
background GBA is pending.  The statistics of ``slam.frame_times_ms``
(``spike_stats``): the largest ``track()`` from the last closure on over
the median frame from call 10 on.  With no closure it prints JAX's ``"no
loop closed"`` line.
"""

from __future__ import annotations

import numpy as np

from ..pipeline.system import SLAM
from . import _frames, _timing

N_FRAMES = 100
DRAIN_FROM, DRAIN_TO = 4, 40   # the frames that drain a pending GBA (bench_loop.py:60-64)


def lap_frames(n: int) -> list:
    """The frame index of each call over two laps of a circle of ``n``
    frames: 0 … n−1, then around again from frame 4 (``bench_loop.py:46-55``)."""
    period = n - 4
    return [i if i < n else ((i - 4) % period) + 4 for i in range(2 * period)]


def spike_stats(ft, closures: list) -> dict:
    """JAX's statistics of the frame times ``ft`` (ms a call) and the calls
    at which a loop closed (``bench_loop.py:73-90``), unrounded."""
    ft = np.asarray(ft, np.float64)
    med = float(np.median(ft[10:]))
    post = ft[closures[-1]:]
    first_post = ft[closures[0]:closures[0] + 20]
    return {
        "metric": "post_loop_frame_spike_ratio",
        "value": float(post.max()) / med,
        "unit": "max_after_last_closure / median_frame_time",
        "detail": {
            "median_frame_ms": med,
            "max_after_last_closure_ms": float(post.max()),
            "p99_after_last_closure_ms": float(np.percentile(post, 99)),
            "first_closure_max_ms": float(first_post.max()),
            "closures": list(closures),
            "frames": int(len(ft)),
        },
    }


def main(argv=None) -> dict:
    ap = _timing.base_parser("bench_loop", __doc__)
    ap.add_argument("--frames", type=int, default=N_FRAMES, help="frames of the circle (JAX: 100)")
    args = ap.parse_args(argv)
    dev = _timing.resolve_device(args.device)
    cfg = _timing.load_config(args.config)
    frames = _frames.render(cfg, args.frames, dev, lap=args.frames, circle=True, box_scale=2.5)
    slam = SLAM(cfg, device=dev)
    closures, prev = [], 0
    for i, j in enumerate(lap_frames(args.frames)):
        slam.track(*frames[j])
        if slam.loops_closed > prev:
            closures.append(i)
            prev = slam.loops_closed
    k = DRAIN_FROM
    while slam._pending_gba is not None and k < DRAIN_TO:
        slam.track(*frames[k])
        k += 1
    _timing.note_slam(slam)
    ft, keyframes = list(slam.frame_times_ms), slam.n_keyframes
    del slam, frames
    _timing.release(dev)
    if not closures:
        out = {"metric": "post_loop_frame_spike", "value": None, "detail": "no loop closed"}
    else:
        out = spike_stats(ft, closures)
        out["detail"].update(device=str(dev), drained=k - DRAIN_FROM, keyframes=keyframes)
    return _timing.emit("bench_loop", dev, out)


if __name__ == "__main__":
    main()
