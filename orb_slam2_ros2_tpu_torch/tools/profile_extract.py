"""Sub-stage cost of the extraction (port of the repository's
``profile_extract.py``)::

    python3 -m orb_slam2_ros2_tpu_torch.tools.profile_extract [--frames 10] [--reps 3]

Each stage runs over T rendered KITTI-size stereo pairs, replayed from one
captured graph, and does everything the stages before it do.  The port
builds the canvas before FAST (one K1 launch over every level of both
images), so the stages follow the port's production order in
``extract_features_batch`` and JAX's labels map onto it as:

* S1 — pyramid + canvas + K1 + keypoint selection (JAX: pyramid + FAST per
  level + select);
* S2 — + canvas centres of the keypoints (JAX: + canvas assembly);
* S3 — + the 48×64 patch gather, K2 (JAX: + patch DMA);
* S4 — + orientations from the patch moments;
* S5 — + BRIEF descriptors (the pre-compare blur folded into the sampling
  matrix, as production).
"""

from __future__ import annotations

import torch

from ..features.extractor import make_stereo_frontend
from . import _frames, _timing

STAGES = ("S1_select", "S2_centers", "S3_patches", "S4_orientations", "S5_describe")


def main(argv=None) -> dict:
    ap = _timing.base_parser("profile_extract", __doc__)
    ap.add_argument("--frames", type=int, default=10, help="T frames a pass (JAX: 10)")
    ap.add_argument("--reps", type=int, default=3, help="passes; the best is kept (JAX: 3)")
    args = ap.parse_args(argv)
    dev = _timing.resolve_device(args.device)
    cfg = _timing.load_config(args.config)
    frames = _frames.render(cfg, args.frames, dev)
    st = _frames.Stages(cfg, make_stereo_frontend(cfg, dev).consts)
    methods = dict(zip(STAGES, (lambda x: st.select(x)[1], st.centers, st.patches, st.orientations, st.describe)))
    ms = {}
    for name, fn in methods.items():
        ms[name] = _timing.scan_time(lambda il, ir, fn=fn: fn(torch.stack([il, ir])), frames, dev, n_rep=args.reps)
        _timing.release(dev)
    deltas, prev = {}, 0.0
    for name in STAGES:
        deltas[name] = ms[name] - prev
        prev = ms[name]
    return _timing.emit("profile_extract", dev, {"frames": args.frames, "reps": args.reps, "ms_per_frame": ms,
                                                 "delta_ms": deltas})


if __name__ == "__main__":
    main()
