"""Per-stage cost of the frame loop (port of the repository's
``profile_scan.py``)::

    python3 -m orb_slam2_ros2_tpu_torch.tools.profile_scan [--frames 10] [--reps 3]

Each stage runs over T rendered KITTI-size frames, progressively more of
the pipeline: A the pyramid of both images; B + FAST+NMS (pyramid, canvas
and one K1 launch, ``ops.fast.fast_score_nms_pyramid``); C the full batched
extraction (``extract_features_batch``, with one K2 launch); D the full
stereo frontend; E the fused odometry step
(``tracking.make_fused_odometry_step``, already a ``StepGraph``), its state
carried from frame to frame.  A-D are captured as one graph each and
replayed over the T frames; the deltas between stages are their costs free
of the host's dispatch.
"""

from __future__ import annotations

import torch

from ..features.extractor import extract_features_batch, make_stereo_frontend
from ..geometry.camera import CameraParams
from ..pipeline.tracking import TrackedFrame, make_fused_odometry_step, unproject_frame
from . import _frames, _timing

STAGES = ("A_pyramid", "B_fast_nms", "C_extract", "D_frontend", "E_odometry")


def main(argv=None) -> dict:
    ap = _timing.base_parser("profile_scan", __doc__)
    ap.add_argument("--frames", type=int, default=10, help="T frames a pass (JAX: 10)")
    ap.add_argument("--reps", type=int, default=3, help="passes; the best is kept (JAX: 3)")
    args = ap.parse_args(argv)
    dev = _timing.resolve_device(args.device)
    cfg = _timing.load_config(args.config)
    cam = CameraParams.from_config(cfg.camera, dev)
    frames = _frames.render(cfg, args.frames, dev)
    frontend = make_stereo_frontend(cfg, dev)
    st = _frames.Stages(cfg, frontend.consts)
    pair = lambda il, ir: torch.stack([il, ir])  # noqa: E731

    bodies = {
        "A_pyramid": lambda il, ir: st.pyramid(pair(il, ir)),
        "B_fast_nms": lambda il, ir: st.fast(pair(il, ir))[1],
        "C_extract": lambda il, ir: extract_features_batch(pair(il, ir), cam, frontend.consts, **frontend.kw),
        "D_frontend": lambda il, ir: frontend(il, ir, cam),
    }
    ms = {}
    for name, body in bodies.items():
        ms[name] = _timing.scan_time(body, frames, dev, n_rep=args.reps)
        _timing.release(dev)

    # E: the fused step over the frames, its state and velocity carried
    step = _timing.Replay(make_fused_odometry_step(cfg, dev), dev)
    sf0 = frontend(*frames[0], cam)
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    pw, has = unproject_frame(cam, sf0, eye)
    state0 = TrackedFrame(frame=sf0, Tcw=eye, pw=pw, has_pw=has)

    def run_seq():
        s, v = state0, eye
        for il, ir in frames:
            s, v, _, _, _ = step(cam, il, ir, s, v)
        return s

    run_seq()
    _timing.sync(dev)
    ms["E_odometry"] = min(_timing.span_ms(run_seq, dev)[0] for _ in range(args.reps)) / len(frames)
    del step
    _timing.release(dev)

    deltas, prev = {}, 0.0
    for name in STAGES:
        deltas[name] = ms[name] - prev
        prev = ms[name]
    return _timing.emit("profile_scan", dev, {"frames": args.frames, "reps": args.reps, "ms_per_frame": ms,
                                              "delta_ms": deltas})


if __name__ == "__main__":
    main()
