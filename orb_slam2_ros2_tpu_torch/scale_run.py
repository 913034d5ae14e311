"""The in-system scale run (port of the repository's ``bench_scale_run.py``)::

    python -m orb_slam2_ros2_tpu_torch.scale_run [--frames 3200] [--lap 800]
        [--radius 30] [--device cuda] [--config cfg.yaml] [--kf-capacity 160]
        [--mp-capacity 32768] [--out result.json]

One long live run of full SLAM (tracking, mapping, loop closing) that
exercises together what the tests see in isolation: the map stores start
small (160 keyframe and 32,768 point slots) and auto-grow through
doublings; past 256 keyframe slots the essential graph takes the PCG route
in-system; a multi-lap circle (``--radius``, 30 m as the reference's) in
the KITTI-like world (``box_scale=2.5``, sky) closes loops at scale.  Keyframing is driven hard
(``ref_ratio_th=1e9`` leaves the cadence gates, a keyframe every ~3rd
frame), with ``th_depth=160``: this world's content sits at 30-80 m.

Prints one JSON line with the JAX script's keys: frames, lost, keyframes
inserted and live, loops, grow events, start and final capacities, map MB
(the map's tensors), ``pcg_essential_in_system`` and the fps curve (one
point every 100 frames); the grow events themselves and the progress go to
stderr as they happen, so a run cut short still shows how far it got.
"""

from __future__ import annotations

import argparse
import dataclasses as dc
import json
import sys
import time
from typing import Callable, Optional

from .config import MapConfig, SLAMConfig
from .io.synthetic import SyntheticStereoDataset, multi_lap_circle_trajectory

T0 = time.time()
WINDOW = 100   # frames a point of the fps curve


def log(msg: str) -> None:
    print(f"[scale {time.time() - T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def scale_config(base: Optional[SLAMConfig] = None, kf_capacity: int = 160,
                 mp_capacity: int = 1 << 15) -> SLAMConfig:
    """``base`` (``SLAMConfig()``) with the scale run's keyframing and its
    small starting stores (``bench_scale_run.py:51-75``)."""
    cfg = base or SLAMConfig()
    return cfg.replace(
        # ThDepth 160 (close < 80 m) for this big world, the reference's own
        # per-dataset tuning; thRefRatio → ∞ leaves the cadence gates
        tracking=dc.replace(cfg.tracking, th_depth=160.0, ref_ratio_th=1e9, min_frames=2, max_frames=5),
        map=MapConfig(max_keyframes=kf_capacity, max_mappoints=mp_capacity, max_obs_per_mp=24,
                      auto_grow=True),
    )


def scale_dataset(cfg: SLAMConfig, n_frames: int, lap: int, device, radius: float = 30.0) -> SyntheticStereoDataset:
    """The KITTI-like world on a multi-lap circle of ``radius`` around
    (0, 0, 40), ``lap`` frames a revolution.  At lap angle a the camera
    stands at x = radius · sin a, and the world's box spans x ∈ [−20, 20]:
    the reference's 30 m circle leaves the box wherever |sin a| > 2/3 (for
    54% of every lap), where the camera faces out of it; a radius under
    20 m keeps every frame inside."""
    ds = SyntheticStereoDataset(cfg.camera, n_frames=4, speed=0.8, box_scale=2.5, sky=True, device=device)
    ds.poses_wc = multi_lap_circle_trajectory(n_frames, frames_per_lap=lap, radius=radius, z_center=40.0)
    ds.n_frames = n_frames
    return ds


def map_bytes(state) -> int:
    """Bytes of the map's tensors."""
    return sum(t.numel() * t.element_size() for t in state)


def run(slam, ds, n_frames: int, track: Optional[Callable] = None) -> dict:
    """Track ``n_frames`` of ``ds``; ``track(img_l, img_r)`` replaces
    ``slam.track``.  Returns the JSON line's fields and the grow events
    (``grow``: frame, capacities before and after, the seconds of that
    call)."""
    track = track or slam.track
    grow_events, curve = [], []
    cap0 = (slam.map.kf_capacity, slam.map.mp_capacity)
    window_t, window_n, lost = time.perf_counter(), 0, 0
    for i in range(n_frames):
        imgL, imgR, _ = ds.frame(i)
        cap_before = (slam.map.kf_capacity, slam.map.mp_capacity)
        t0 = time.perf_counter()
        pose, _ = track(imgL, imgR)
        call_s = time.perf_counter() - t0
        if pose is None:
            lost += 1
            if lost <= 3:
                log(f"lost at frame {i}")
        cap_after = (slam.map.kf_capacity, slam.map.mp_capacity)
        if cap_after != cap_before:
            grow_events.append(dict(frame=i, frm=list(cap_before), to=list(cap_after), call_s=call_s))
            log(f"auto-grow at frame {i}: {cap_before} -> {cap_after}")
        window_n += 1
        if window_n == WINDOW:
            dt = time.perf_counter() - window_t
            curve.append(dict(frame=i + 1, n_kf=slam._n_kf, live_kf=slam.n_keyframes,
                              fps=round(WINDOW / dt, 2), map_mb=round(map_bytes(slam.map) / 1e6, 1),
                              loops=slam.loops_closed))
            log(f"frame {i + 1}: {json.dumps(curve[-1])}")
            window_t, window_n = time.perf_counter(), 0
    slam.flush()
    return dict(
        frames=n_frames, lost=lost, keyframes_inserted=slam._n_kf, keyframes_live=slam.n_keyframes,
        loops_closed=slam.loops_closed, grow_events=len(grow_events), grow=grow_events,
        start_capacity=list(cap0), final_capacity=[slam.map.kf_capacity, slam.map.mp_capacity],
        final_map_mb=round(map_bytes(slam.map) / 1e6, 1),
        pcg_essential_in_system=slam.map.kf_capacity > 256, fps_curve=curve,
    )


def main(argv=None) -> dict:
    from .pipeline.system import SLAM

    ap = argparse.ArgumentParser(prog="orb_slam2_ros2_tpu_torch.scale_run")
    ap.add_argument("--frames", type=int, default=3200)
    ap.add_argument("--lap", type=int, default=800)
    ap.add_argument("--device", default="cuda", help="torch device to render and track on")
    ap.add_argument("--config", default="", help="YAML config under the scale run's overrides "
                                                "(default: SLAMConfig())")
    ap.add_argument("--radius", type=float, default=30.0,
                    help="circle radius in metres (30 as the reference; under 20 stays in the box)")
    ap.add_argument("--kf-capacity", type=int, default=160, help="keyframe slots at the start")
    ap.add_argument("--mp-capacity", type=int, default=1 << 15, help="map-point slots at the start")
    ap.add_argument("--out", default="", help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    base = SLAMConfig.from_yaml(args.config) if args.config else None
    cfg = scale_config(base, args.kf_capacity, args.mp_capacity)
    slam = SLAM(cfg, device=args.device)
    res = run(slam, scale_dataset(cfg, args.frames, args.lap, args.device, args.radius), args.frames)
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    if res["fps_curve"]:
        c = res["fps_curve"][-1]
        log(f"| {args.frames} frames | {res['keyframes_live']} live KFs | {c['fps']} fps (last window) | "
            f"{c['map_mb']} map MB | {res['loops_closed']} loops |")
    return res


if __name__ == "__main__":
    main()
