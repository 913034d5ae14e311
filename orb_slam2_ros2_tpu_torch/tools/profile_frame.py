"""Stage breakdown of the production per-frame program (port of the
repository's ``profile_frame.py``)::

    python3 -m orb_slam2_ros2_tpu_torch.tools.profile_frame [--frames 20] [--warm 44] [--reps 3]

Builds a map with full SLAM on the KITTI-like world (``th_depth=60``,
``box_scale=2.5``, sky, no loop closing, WARM frames), then replays
cumulative truncations of the frame over T frames of the return pass
(frames WARM−2, WARM−3, …), each captured as its own graph; the deltas are
the stages' costs free of the host's dispatch:

  frontend   = pyramid + FAST (K1) + patches (K2) + BRIEF + stereo SAD
  match1     = + motion-model hamming/area/mutual (both radii)
  opt1       = + stage-1 pose LM
  match2     = + local-map projection search
  vis        = + the visibility pass
  opt2       = + stage-3 pose LM
  full       = + counters and stats of ``slam_track_step``
  frame      = + counter bumps, best reference, stats, the frame-centred
               local map (``SLAM.frame_program``, what the frame graph replays)
  frame+snap = the same with the local map's points kept live

The truncations are ``slam_track_step(stop_after=...)``.  The frame stages
run on a copy of the map (the program bumps its counters in place).
"""

from __future__ import annotations

import torch

from ..pipeline.frame_graph import id_tensor
from ..pipeline.system import SLAM, slam_track_step
from . import _frames, _timing

STAGES = ("frontend", "match1", "opt1", "match2", "vis", "opt2", "full", "frame", "frame+snap")


def main(argv=None) -> dict:
    ap = _timing.base_parser("profile_frame", __doc__)
    ap.add_argument("--frames", type=int, default=20, help="T frames of the return pass (JAX: 20)")
    ap.add_argument("--warm", type=int, default=44, help="frames that build the map (JAX: 44)")
    ap.add_argument("--reps", type=int, default=3, help="passes; the best is kept (JAX: 3)")
    args = ap.parse_args(argv)
    if args.frames > args.warm - 1:
        raise ValueError("--frames must be below --warm")
    dev = _timing.resolve_device(args.device)
    cfg = _frames.with_th_depth(_timing.load_config(args.config))
    frames = _frames.render(cfg, args.warm, dev, box_scale=2.5, sky=True)
    slam = SLAM(cfg, enable_loop_closing=False, device=dev)
    tracked = _frames.run_slam(slam, frames)
    _timing.note_slam(slam)
    rev = [frames[i] for i in range(args.warm - 2, args.warm - 2 - args.frames, -1)]

    cam, fe = slam.cam, slam._frontend
    last, vel, local = slam.last, slam.velocity, slam.local
    mp_pos, mp_valid = slam.map.mp_pos, slam.map.mp_valid
    mapstate = _frames.clone(slam.map)
    ref = id_tensor(slam.ref_kf, dev)

    def truncated(stage):
        return lambda il, ir: slam_track_step(cam, fe(il, ir, cam), last, vel, local, mp_pos, mp_valid,
                                              proj_th=3.0, stop_after=stage, **slam._track_common)

    def frame(il, ir):
        return slam.frame_program(il, ir, last, vel, local, mapstate, ref)[2]

    def frame_snap(il, ir):
        out = slam.frame_program(il, ir, last, vel, local, mapstate, ref)
        return out[2], out[4].pos

    bodies = {"frontend": lambda il, ir: fe(il, ir, cam)}
    bodies.update({s: truncated(s) for s in STAGES[1:7]})
    bodies.update({"frame": frame, "frame+snap": frame_snap})
    ms = {}
    for name in STAGES:
        ms[name] = _timing.scan_time(bodies[name], rev, dev, n_rep=args.reps)
        _timing.release(dev)
    deltas, prev = {}, 0.0
    for name in STAGES:
        deltas[name] = ms[name] - prev
        prev = ms[name]
    out = {"frames": args.frames, "warm": args.warm, "reps": args.reps, "tracked": tracked,
           "keyframes": slam.n_keyframes, "mappoints": slam.n_mappoints, "ms_per_frame": ms, "delta_ms": deltas}
    del slam, bodies, mapstate
    _timing.release(dev)
    return _timing.emit("profile_frame", dev, out)


if __name__ == "__main__":
    main()
