"""Command-line drivers (port of ``orb_slam2_ros2_tpu/cli.py``): the
reference's example binaries (example/Stereo/KittiStereo.cc,
example/RGB-D/TUMRGBD.cc) as one CLI::

    python -m orb_slam2_ros2_tpu_torch.cli kitti --seq /path/to/00 --config cfg.yaml
    python -m orb_slam2_ros2_tpu_torch.cli tum   --seq /path/to/fr2_desk
    python -m orb_slam2_ros2_tpu_torch.cli synth --frames 200 --circle   # no dataset needed
    python -m orb_slam2_ros2_tpu_torch.cli train-vocab --out vocab.npz

Tracks on the GPU (``--device cuda``, the default; ``--device cpu`` runs the
kernels' plain versions on the CPU).  Writes ``<out>.kitti.txt`` and
``<out>.tum.txt`` and prints one JSON line with the JAX CLI's keys,
evaluating ATE where ground truth exists.  ``kitti`` and ``tum`` decode each
image on the host (``io/datasets.py``) and ``track`` copies it to the device;
``synth`` renders on the device.  The JAX CLI's persistent XLA compile cache
has no counterpart: the CUDA kernels are compiled once into ``build/`` at
the repository root and reused from there.  ``--trace DIR`` writes a
``torch.profiler`` Chrome trace to ``DIR/trace.json``.  ``--distributed``
joins a multi-process run through the ``SLAM_*`` variables
(``parallel.mesh.init_distributed``); ``--ba-devices N`` shards the
essential graph and the global BA over N devices.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from .config import SLAMConfig
from .io import trajectory as traj_io


def _build_cfg(args, width: int, height: int) -> SLAMConfig:
    cfg = SLAMConfig.from_yaml(args.config) if args.config else SLAMConfig()
    cam = cfg.camera
    if (width, height) != (cam.width, cam.height):
        cfg = cfg.replace(camera=dataclasses.replace(cam, width=width, height=height))
    if args.pipelined:
        cfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking, pipelined=True))
    if args.distributed:
        from .parallel.mesh import init_distributed

        # gloo for a CPU run, whether or not the machine has a card
        pid = init_distributed(backend="gloo" if torch.device(args.device).type == "cpu" else None)
        print(f"[distributed] process {pid}", file=sys.stderr)
    if args.ba_devices > 1:
        cfg = cfg.replace(dist=type(cfg.dist)(n_devices=args.ba_devices, mesh_axis=cfg.dist.mesh_axis))
    return cfg


def _align_pipelined(slam, poses, n):
    """Pipelined tracking returns poses one frame late: rebuild the per-frame
    pose list from the resolve-time trajectory records so the exported files
    stay frame-aligned."""
    if not slam.cfg.tracking.pipelined:
        return poses
    slam.flush()
    by_fid = {f: np.linalg.inv(T) for f, T in slam.trajectory}
    return [by_fid.get(i) for i in range(n)]


def _track_sequence(slam, frame, n: int, args):
    """Track frames 0..n-1 of ``frame(i) -> (a, b, stamp, Twc_gt or None)``;
    returns (Twc poses or None, stamps, ground truth, wall seconds)."""
    viewer = None
    if args.viewer:
        from .viewer import LiveViewer

        viewer = LiveViewer(slam, every=args.viewer_every, out_dir=args.viewer)
    poses, stamps, gt = [], [], []
    t0 = time.time()
    for i in range(n):
        a, b, stamp, Twc_gt = frame(i)
        Tcw, stats = slam.track(a, b)
        poses.append(np.linalg.inv(Tcw) if Tcw is not None else None)
        stamps.append(stamp)
        gt.append(Twc_gt)
        if viewer is not None:
            viewer.update(Tcw)
        if i % 50 == 0:
            print(f"frame {i}/{n}: {stats}", file=sys.stderr)
    wall = time.time() - t0
    poses = _align_pipelined(slam, poses, n)
    if viewer is not None:
        viewer.close()
    return poses, stamps, gt, wall


def _new_slam(cfg: SLAMConfig, args, rgbd: bool = False):
    from .pipeline.system import SLAM

    slam = SLAM(cfg, rgbd=rgbd, device=args.device)
    if args.load_map:
        slam.load(args.load_map)
    return slam


def _run_sequence(args) -> dict:
    """One ``kitti`` / ``tum`` / ``synth`` run: track, write both trajectory
    files, save the map if asked; returns the JSON line's fields."""
    if args.cmd == "kitti":
        from .io.datasets import KittiStereoDataset, load_kitti_gt

        ds = KittiStereoDataset(args.seq)
        h, w = ds.frame(0)[0].shape
        slam = _new_slam(_build_cfg(args, w, h), args)
        n = min(len(ds), args.frames) if args.frames else len(ds)
        poses, stamps, _, wall = _track_sequence(slam, lambda i: (*ds.frame(i), None), n, args)
        # KITTI ground-truth row i is frame i
        gt_all = load_kitti_gt(args.seq, args.gt)
        gt = list(gt_all[: len(poses)]) if gt_all is not None else None
    elif args.cmd == "tum":
        from .io.datasets import TumRGBDDataset, associate_gt, load_tum_gt

        ds = TumRGBDDataset(args.seq)
        h, w = ds.frame(0)[0].shape
        slam = _new_slam(_build_cfg(args, w, h), args, rgbd=True)
        n = min(len(ds), args.frames) if args.frames else len(ds)
        poses, stamps, _, wall = _track_sequence(slam, lambda i: (*ds.frame(i), None), n, args)
        tum_gt = load_tum_gt(args.seq, args.gt)
        gt = associate_gt(stamps, *tum_gt) if tum_gt is not None else None
    else:  # synth
        from .io.synthetic import SyntheticStereoDataset

        n = args.frames or 100
        cfg = _build_cfg(args, 1241, 376)
        ds = SyntheticStereoDataset(cfg.camera, n_frames=n, speed=args.speed, circle=args.circle,
                                    device=args.device)
        slam = _new_slam(cfg, args)

        def synth_frame(i):
            img_l, img_r, Twc = ds.frame(i)
            return img_l, img_r, i * 0.1, Twc

        poses, stamps, gt, wall = _track_sequence(slam, synth_frame, n, args)

    tracked = [p for p in poses if p is not None]
    out = {
        "frames": len(poses),
        "tracked": len(tracked),
        "fps": round(len(poses) / wall, 2),
        "keyframes": slam.n_keyframes,
        "mappoints": slam.n_mappoints,
        "loops_closed": slam.loops_closed,
    }
    ft = slam.frame_times_ms
    if len(ft) > 4:  # per-frame timing without the first frames (captures, warm-ups)
        steady = np.asarray(ft[4:])
        out["frame_ms_median"] = round(float(np.median(steady)), 1)
        out["frame_ms_p90"] = round(float(np.percentile(steady, 90)), 1)
    if gt is not None and len(tracked) > len(poses) // 2:
        pairs = [(p, g) for p, g in zip(poses, gt) if p is not None and g is not None]
        if len(pairs) >= 3:
            out["ate_rmse"] = round(traj_io.ate_rmse([a for a, _ in pairs], [b for _, b in pairs]), 4)
            out["ate_frames"] = len(pairs)

    filled = [p if p is not None else np.eye(4) for p in poses]
    traj_io.write_kitti(args.out + ".kitti.txt", filled)
    traj_io.write_tum(args.out + ".tum.txt", stamps, filled)
    if args.save_map:
        slam.save(args.save_map)
    return out


def _train_vocab(args) -> None:
    """Offline vocabulary training (the reference ships DBoW3's pre-trained
    ORBvoc, System.cc:92-95; this trains on extracted ORB descriptors — of a
    KITTI sequence when given, else of two synthetic trajectories)."""
    from .bow.vocabulary import save_vocabulary, train_vocabulary
    from .features.extractor import make_stereo_frontend
    from .geometry.camera import CameraParams

    if args.seq:
        from .io.datasets import KittiStereoDataset

        ds = KittiStereoDataset(args.seq)
        h, w = ds.frame(0)[0].shape
        cfg = SLAMConfig().replace(camera=SLAMConfig().camera.__class__(width=w, height=h))
        n_frames = min(args.frames, len(ds))
    else:
        from .io.synthetic import SyntheticStereoDataset

        cfg = SLAMConfig()
        # two trajectories through the box: distinct wall and floor viewpoints
        ds_fwd = SyntheticStereoDataset(cfg.camera, n_frames=args.frames, speed=1.6, device=args.device)
        ds_cir = SyntheticStereoDataset(cfg.camera, n_frames=args.frames, circle=True, device=args.device)
        n_frames = args.frames

    cam = CameraParams.from_config(cfg.camera, args.device)
    frontend = make_stereo_frontend(cfg, args.device)
    descs = []
    for i in range(n_frames):
        if args.seq:
            left, right, _ = ds.frame(i)
            frames = [(torch.from_numpy(left).to(args.device), torch.from_numpy(right).to(args.device))]
        else:
            frames = [ds_fwd.frame(i)[:2], ds_cir.frame(i)[:2]]
        for left, right in frames:
            f = frontend(left, right, cam)
            descs.append(f.feats.desc[f.feats.valid].cpu().numpy())
        if i % 10 == 0:
            print(f"[train-vocab] frame {i}/{n_frames}", file=sys.stderr)
    alld = np.concatenate(descs)
    print(f"[train-vocab] {len(alld)} descriptors → k={args.branching} L={args.depth}", file=sys.stderr)
    vocab = train_vocabulary(alld, branching=args.branching, depth=args.depth)
    save_vocabulary(vocab, args.out)
    print(json.dumps({"descriptors": int(len(alld)), "words": vocab.n_words, "out": args.out}))


@contextlib.contextmanager
def _tracing(trace_dir: str, device: str):
    """A ``torch.profiler`` trace of the run written to
    ``trace_dir/trace.json`` (the counterpart of ``jax.profiler``'s trace)."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def main(argv=None):
    p = argparse.ArgumentParser(prog="orb_slam2_ros2_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("kitti", "tum", "synth"):
        q = sub.add_parser(name)
        q.add_argument("--seq", default="")
        q.add_argument("--config", default="")
        q.add_argument("--frames", type=int, default=0)
        q.add_argument("--out", default="trajectory")
        q.add_argument("--save-map", default="",
                       help="map output: *.pb = reference protobuf, dir/ = "
                            "reference txt streams, else native npz")
        q.add_argument("--load-map", default="",
                       help="map input: *.pb, txt-stream directory, or npz stem")
        q.add_argument("--speed", type=float, default=0.8)
        q.add_argument("--circle", action="store_true")
        q.add_argument("--gt", default="", help="ground-truth pose file (auto-detected if omitted)")
        q.add_argument("--trace", default="",
                       help="write a torch.profiler Chrome trace of the run to DIR/trace.json")
        q.add_argument("--distributed", action="store_true",
                       help="join a multi-process run (SLAM_COORDINATOR, SLAM_NUM_PROCESSES, "
                            "SLAM_PROCESS_ID)")
        q.add_argument("--ba-devices", type=int, default=0,
                       help="shard the essential graph and the global BA over N devices")
        q.add_argument("--pipelined", action="store_true",
                       help="pipelined tracking (deployment mode): overlap "
                            "the per-frame host fetch with the next frame's "
                            "device execution; poses return one frame late")
        q.add_argument("--viewer", default="",
                       help="live viewer (reference Viewer.cc): render "
                            "trajectory/map/graph/HUD every --viewer-every "
                            "frames to this directory (and to a window when "
                            "a display exists)")
        q.add_argument("--viewer-every", type=int, default=10)
        q.add_argument("--device", default="cuda", help="torch device to track on")
    tv = sub.add_parser("train-vocab", help="train a BoW vocabulary offline "
                        "(replaces shipping DBoW3's ORBvoc, reference System.cc:92-95)")
    tv.add_argument("--out", default="vocab.npz")
    tv.add_argument("--frames", type=int, default=48)
    tv.add_argument("--branching", type=int, default=10)
    tv.add_argument("--depth", type=int, default=4)
    tv.add_argument("--seq", default="", help="optional KITTI sequence dir (synthetic scenes if omitted)")
    tv.add_argument("--device", default="cuda", help="torch device to extract features on")
    args = p.parse_args(argv)

    if args.cmd == "train-vocab":
        _train_vocab(args)
        return
    with _tracing(args.trace, args.device):
        out = _run_sequence(args)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
