"""A ``torch.profiler`` trace of the stereo frontend's graph (port of the
repository's ``profile_trace.py``, which takes a ``jax.profiler`` trace of
the scanned frontend)::

    python3 -m orb_slam2_ros2_tpu_torch.tools.profile_trace [--frames 10] [--out DIR]

The frontend is captured as one graph and replayed over T rendered
KITTI-size stereo pairs under the profiler.  The per-kernel table (name,
calls, total and mean device µs) goes as CSV to ``DIR/op_stats.csv``
(default: a new temporary directory); the JSON line holds the top 20 by
device time and the runs of K1 (``fast_nms``) and K2 (``patches``) the
trace shows, which should be one each a replay.  The profiler has been
seen to lose a block of a replay's kernel records (about one session in
thirty), so a session whose K1 or K2 count falls short is traced again,
once; every session's counts are reported.
"""

from __future__ import annotations

import csv
import os
import tempfile

from ..features.extractor import make_stereo_frontend
from ..geometry.camera import CameraParams
from . import _frames, _timing

KERNELS = {"fast_nms": "fast_nms_kernel", "patches": "patches_kernel"}
TOP = 20        # kernels in the JSON line
SESSIONS = 2    # profiler sessions at most


def main(argv=None) -> dict:
    ap = _timing.base_parser("profile_trace", __doc__)
    ap.add_argument("--frames", type=int, default=10, help="T replays traced (JAX: 10)")
    ap.add_argument("--out", default="", help="directory of op_stats.csv (default: a new temporary one)")
    args = ap.parse_args(argv)
    dev = _timing.resolve_device(args.device)
    cfg = _timing.load_config(args.config)
    cam = CameraParams.from_config(cfg.camera, dev)
    frames = _frames.render(cfg, args.frames, dev)
    frontend = make_stereo_frontend(cfg, dev)
    step = _timing.Replay(lambda il, ir: _timing.reduce_sum(frontend(il, ir, cam)), dev)
    step(*frames[0])

    sessions = []
    for _ in range(SESSIONS):
        prof = _timing.kernel_profile(lambda: [step(*x) for x in frames], dev, top=TOP)
        seen = {k: sum(r["calls"] for r in prof["rows"] if pat in r["name"]) for k, pat in KERNELS.items()}
        sessions.append({"kernels": prof["kernels"], "kernel_ms": prof["kernel_ms"],
                         "graph_launches": prof["graph_launches"], **seen})
        if dev.type != "cuda" or all(n >= len(frames) for n in seen.values()):
            break
    out_dir = args.out or tempfile.mkdtemp(prefix="profile_trace_")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "op_stats.csv")
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["name", "calls", "total_us", "mean_us"])
        w.writeheader()
        w.writerows(prof["rows"])
    last = sessions[-1]
    return _timing.emit("profile_trace", dev, {
        "replays": len(frames), "sessions": sessions, "fast_nms": last["fast_nms"], "patches": last["patches"],
        "kernels_per_replay": last["kernels"] / len(frames), "kernel_ms_per_replay": last["kernel_ms"] / len(frames),
        "csv": path, "top": prof["top"]})


if __name__ == "__main__":
    main()
