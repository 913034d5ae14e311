"""The port's entry points: the per-frame tracking program with example
inputs, and the multi-device dry run.

The counterparts of the JAX package's ``__graft_entry__.entry()`` and
``dryrun_multichip``, at their shapes.  ``entry`` is 320×192 stereo,
``n_features=500``, ``max_keypoints=512``, 64 keyframe and 16,384 map-point
slots, a ``SLAM`` initialized on frame 0 of the synthetic sequence and frame
1's images as the input:

    fn, args = entry()            # on the card
    new_state, velocity, host_vec, mapstate, local = fn(*args)

On CUDA ``fn`` replays the captured frame graph (its first call captures it);
with ``device="cpu"`` it is the eager frame program.

``dryrun_multichip(n)`` runs the three multi-device paths over an n-slot
mesh: the landmark-sharded global BA (C=256 cameras, P=12,500·n landmarks,
O=4) and the edge-sharded essential-graph PCG (K=512 vertices), each
against its one-shard solve, and the tracker/mapper split tracking real
frames, on the visible cards unless ``devices`` names the slots:
``devices=["cuda:0", "cuda:0"]`` puts two shards on one card and
``devices=["cpu"] * n`` runs on the CPU; without a card and without
``devices`` it raises.
``run_ranks`` solves the same problems over processes joined by
``torch.distributed`` (``init_distributed`` through the ``SLAM_*``
variables), one shard a process.
"""

from __future__ import annotations

import os
import socket
import time

import numpy as np
import torch

from .config import (
    BAConfig,
    BoWConfig,
    CameraConfig,
    DistConfig,
    MapConfig,
    ORBConfig,
    SLAMConfig,
    TrackingConfig,
)
from .geometry import se3, sim3
from .geometry.camera import CameraParams, project
from .io.synthetic import SyntheticStereoDataset
from .parallel.mesh import Mesh, ba_mesh, init_distributed, local_devices
from .pipeline.system import SLAM
from .solvers.pcg_ba import PointBAProblem, solve_global_ba, solve_global_ba_sharded
from .solvers.pose_graph import PoseGraphProblem, make_relative_measurements, optimize_pose_graph


def entry_config() -> SLAMConfig:
    """The configuration of ``__graft_entry__.entry()``."""
    return SLAMConfig(
        camera=CameraConfig(fx=200.0, fy=200.0, cx=160.0, cy=96.0, baseline=0.5,
                            width=320, height=192),
        orb=ORBConfig(n_features=500, max_keypoints=512),
        tracking=TrackingConfig(min_init_depth_kps=150, max_local_mappoints=4096,
                                max_local_keyframes=16),
        map=MapConfig(max_keyframes=64, max_mappoints=16384, max_obs_per_mp=16),
    )


def entry(device="cuda"):
    """Returns ``(fn, args)``: ``fn(img_l, img_r, last, velocity, local,
    mapstate, ref_kf)`` is the frame program of a ``SLAM`` initialized on
    synthetic frame 0 (frontend → motion match + pose LM → local-map search +
    refinement → counter bumps → stats), ``args`` frame 1's images, that
    SLAM's tracker state, its map and reference keyframe (a host int).
    Returns ``(new_state, velocity, host_vec, mapstate, local)``: the map is
    the SLAM's own (another ``mapstate`` is copied into it first), its
    tracking counters bumped in place, as ``SLAM.track`` does."""
    cfg = entry_config()
    ds = SyntheticStereoDataset(cfg.camera, n_frames=4, speed=0.35, device=device)
    slam = SLAM(cfg, enable_loop_closing=False, device=device)
    slam.track(*ds.frame(0)[:2])  # stereo init → keyframe 0 + local map
    img_l, img_r, _ = ds.frame(1)
    args = (img_l, img_r, slam.last, slam.velocity, slam.local, slam.map, slam.ref_kf)

    def fn(img_l, img_r, last, velocity, local, mapstate, ref_kf):
        # the SLAM's own frame step (graph or eager) on that map and keyframe
        slam.map, slam.ref_kf = mapstate, ref_kf
        new_state, velocity, host_vec, local = slam._run_frame(
            img_l, img_r, last, velocity, local, wide=False)
        return new_state, velocity, host_vec, slam.map, local

    return fn, args


# --------------------------------------------------------------------------
# the multi-device dry run (``__graft_entry__.dryrun_multichip``)
# --------------------------------------------------------------------------

DRYRUN_CAMERA = CameraConfig(fx=100.0, fy=100.0, cx=64.0, cy=48.0, baseline=0.5, width=128, height=96)
GBA_KW = dict(phase_iters=(1, 1), pcg_iters=8)
PG_KW = dict(iters=5, cg_iters=60)


def gba_problem(C: int, P: int, O: int = 4, device="cuda", seed: int = 0):
    """The dry run's global-BA problem: a forward corridor of C cameras
    (0.3 m apart, mild yaw); each of P landmarks anchored ahead of a random
    camera, seen by the next O cameras, half of the observations stereo;
    the landmarks perturbed by 5 cm.  Returns (camera, PointBAProblem)."""
    cam = CameraParams.from_config(DRYRUN_CAMERA, device)
    r = np.random.default_rng(seed)
    anchor = r.integers(0, C - O, P).astype(np.int32)
    pts_gt = np.stack([r.uniform(-3, 3, P), r.uniform(-1, 1, P),
                       0.3 * anchor + r.uniform(4, 12, P)], 1).astype(np.float32)
    xi = np.zeros((C, 6), np.float32)
    xi[:, 2] = -0.3 * np.arange(C)
    xi[:, 4] = 0.002 * np.arange(C)
    Tcw = se3.exp(torch.from_numpy(xi)).numpy()
    obs_cam = anchor[:, None] + np.arange(O, dtype=np.int32)[None, :]
    pc = np.einsum("poij,pj->poi", Tcw[obs_cam][..., :3, :3], pts_gt) + Tcw[obs_cam][..., :3, 3]
    uv = project(CameraParams.from_config(DRYRUN_CAMERA, "cpu"), torch.from_numpy(pc))[0].numpy()
    ru = uv[..., 0] - DRYRUN_CAMERA.bf / np.maximum(pc[..., 2], 0.1)
    ru = np.where(r.random((P, O)) < 0.5, ru, -1.0).astype(np.float32)
    in_img = ((uv[..., 0] >= 0) & (uv[..., 0] < DRYRUN_CAMERA.width)
              & (uv[..., 1] >= 0) & (uv[..., 1] < DRYRUN_CAMERA.height))
    cam_free = np.arange(C) != 0
    pts = pts_gt + r.normal(0, 0.05, (P, 3)).astype(np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return cam, PointBAProblem(
        cam_Tcw=t(Tcw), cam_free=t(cam_free), pt_pos=t(pts), pt_valid=t(np.ones(P, bool)),
        obs_cam=t(obs_cam), obs_uv=t(uv.astype(np.float32)), obs_right_u=t(ru),
        obs_inv_sigma2=t(np.ones((P, O), np.float32)), obs_valid=t(in_img))


def pose_graph_problem(K: int, device="cuda", seed: int = 0) -> PoseGraphProblem:
    """The dry run's essential graph: a drift chain of K vertices (noisy
    odometry) and a loop edge from the last back to the first carrying the
    true relative pose; vertex 0 fixed."""
    r = np.random.default_rng(seed)
    step = se3.exp(torch.tensor([0.4, 0, 0.03, 0, 0.012, 0])).numpy()
    noise = se3.exp(torch.from_numpy(np.concatenate(
        [r.normal(0, 0.01, (K, 3)), r.normal(0, 0.002, (K, 3))], 1).astype(np.float32))).numpy()
    gt, est = [np.eye(4, dtype=np.float32)], [np.eye(4, dtype=np.float32)]
    for i in range(1, K):
        gt.append(step @ gt[-1])
        est.append(step @ noise[i] @ est[-1])
    S_est = sim3.from_se3(torch.from_numpy(np.stack(est).astype(np.float32)).to(device))
    ei = torch.tensor(list(range(K - 1)) + [0], dtype=torch.int32, device=device)
    ej = torch.tensor(list(range(1, K)) + [K - 1], dtype=torch.int32, device=device)
    S_meas = make_relative_measurements(S_est, ei, ej)
    S_gt = sim3.from_se3(torch.from_numpy(np.stack(gt).astype(np.float32)).to(device))
    true = make_relative_measurements(S_gt, ei[-1:], ej[-1:])
    S_meas = sim3.Sim3(*(torch.cat([a[:-1], b]) for a, b in zip(S_meas, true)))
    ones = torch.ones(K, dtype=torch.bool, device=device)
    return PoseGraphProblem(S_cw=S_est, kf_valid=ones, kf_fixed=torch.arange(K, device=device) == 0,
                            edge_i=ei, edge_j=ej, edge_Sji=S_meas, edge_valid=ones,
                            edge_weight=torch.ones(K, device=device))


def sharded_solves(mesh, C: int, P: int, K: int, device) -> dict:
    """The dry run's global BA and essential graph over ``mesh`` (one shard
    each of its local slots): their results, on the host."""
    cam, prob = gba_problem(C, P, device=device)
    Tcw, pts, gate = solve_global_ba_sharded(cam, prob, mesh, **GBA_KW)
    S = optimize_pose_graph(pose_graph_problem(K, device), mesh=mesh, **PG_KW)
    return dict(Tcw=Tcw.cpu(), pts=pts.cpu(), gate=gate.cpu(), pg_T=sim3.to_se3(S).cpu())


def rank_solves(rank: int, world: int, coordinator: str, device: str, C: int, P: int, K: int,
                out_dir: str, threads: int = 0) -> None:
    """One process of a ``world``-process run (``run_ranks``): joins the
    process group through the ``SLAM_*`` variables over gloo, solves the
    dry run's problems with one shard on ``device`` and saves the results
    as ``out_dir/rank<rank>.pt``.  Its mesh spans several processes, so it
    is not ``capturable``: the solves run eagerly, and a rank that finds
    its mesh capturable raises."""
    if threads:
        torch.set_num_threads(threads)
    os.environ.update(SLAM_COORDINATOR=coordinator, SLAM_NUM_PROCESSES=str(world),
                      SLAM_PROCESS_ID=str(rank))
    init_distributed(backend="gloo")
    try:
        mesh = ba_mesh(world, devices=[device])
        if mesh.capturable:
            raise RuntimeError(f"rank {rank}: a mesh over {world} processes was taken for capturable")
        res = sharded_solves(mesh, C, P, K, device)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(world: int, device: str, C: int, P: int, K: int, out_dir: str, *,
              timeout: float = 300.0, threads: int = 0) -> list:
    """``world`` processes (spawned), one shard each on ``device``, joined
    over gloo on localhost: each one's ``sharded_solves`` results, by rank.
    Raises if a process fails or the run outlasts ``timeout`` seconds (the
    processes are then terminated)."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(rank_solves, nprocs=world, join=False, start_method="spawn",
                             args=(world, f"localhost:{_free_port()}", device, C, P, K, out_dir, threads))
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks did not finish within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join()
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(world)]


def _timed(fn, device, reps: int = 2):
    """(result, best ms of ``reps`` runs after one warm-up, peak MiB): CUDA
    events and the peak device memory the runs allocated above what was
    allocated before them on a card, the host clock and None otherwise."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        before = torch.cuda.memory_allocated(device)
    out = fn()
    best = float("inf")
    for _ in range(reps):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            out = fn()
            best = min(best, (time.perf_counter() - t0) * 1000.0)
    peak = (torch.cuda.max_memory_allocated(device) - before) / 2 ** 20 if device.type == "cuda" else None
    return out, best, peak


def _rot_deg(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Angles (degrees) between the rotations of two pose stacks."""
    R = A[..., :3, :3].transpose(-1, -2).double() @ B[..., :3, :3].double()
    skew = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]], -1)
    return torch.rad2deg(torch.arcsin((0.5 * skew.norm(dim=-1)).clamp(max=1.0)))


def gba_gap(solved, one, pt_valid: torch.Tensor) -> dict:
    """How far a global-BA solve ``solved`` (Tcw, points, gates) lies from
    the one-shard solve ``one`` of the same problem: the largest camera
    translation (m) and rotation (°) difference, the largest point
    difference beyond 1 mm + 2e-4·|p| over the valid points (≤ 0 inside
    it) and the number of gates that differ."""
    (Tn, pn, gn), (T1, p1, g1) = solved, one
    return dict(pose_diff_m=float((Tn[:, :3, 3] - T1[:, :3, 3]).abs().max()),
                rot_diff_deg=float(_rot_deg(Tn, T1).max()),
                point_excess_m=float(((pn - p1).abs() - (1e-3 + 2e-4 * p1.abs()))[pt_valid].max()),
                gate_diff=int((gn != g1).sum()))


def split_config() -> SLAMConfig:
    """The split's configuration in the dry run (the JAX dry run's)."""
    return SLAMConfig(
        camera=CameraConfig(fx=200.0, fy=200.0, cx=160.0, cy=96.0, baseline=0.5, width=320, height=192),
        orb=ORBConfig(n_features=500, max_keypoints=512),
        tracking=TrackingConfig(min_init_depth_kps=120, max_local_mappoints=4096, max_local_keyframes=16),
        map=MapConfig(max_keyframes=32, max_mappoints=8192, max_obs_per_mp=12),
        bow=BoWConfig(branching=4, depth=2),
        ba=BAConfig(pcg_iters=15),
        dist=DistConfig(tracker_mapper_split=True),
    )


SPLIT_FRAMES = 12


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run the three multi-device paths over the first ``n_devices`` slots
    of ``devices`` (every visible card when None, ``n_devices=1`` too; it
    raises without a card unless ``devices`` names the CPU's slots):

    1. the landmark-sharded global BA, C=256 cameras, P=12,500·n
       landmarks, O=4, against the one-shard solve of the same problem;
    2. the edge-sharded essential-graph PCG at K=512 vertices (more than
       ``DENSE_MAX_K``), against the one-shard PCG;
    3. (n ≥ 2) the tracker/mapper split tracking 12 frames, the map on
       the second device: on a card the tracker program and the
       bookkeeping replay CUDA graphs, as the keyframe programs do.

    Prints one ``dryrun i/3`` line each and returns the device the solves
    ran on, the timings (ms, CUDA events on a card), the peak device memory, the largest differences
    between the sharded and one-shard results and the split's map-side
    graph captures and replays (the wrappers' calls on the CPU)."""
    # one slot is a mesh of one device, as JAX's dry run makes it (ba_mesh
    # gives None there, where the SLAM takes its unsharded paths)
    mesh = (ba_mesh(n_devices, devices=devices) if n_devices > 1
            else Mesh(axis="ba", slots=((0, local_devices(devices)[0]),)))
    dev = mesh.device
    on_card = dev.type == "cuda"
    out = {"device": str(dev)}
    C, P, K = 256, 12500 * n_devices, 512
    cam, prob = gba_problem(C, P, device=dev)
    (Tn, pn, gn), ms_n, peak_n = _timed(lambda: solve_global_ba_sharded(cam, prob, mesh, **GBA_KW), dev)
    (T1, p1, g1), ms_1, peak_1 = _timed(lambda: solve_global_ba(cam, prob, **GBA_KW), dev)
    if not (torch.isfinite(Tn).all() and torch.isfinite(pn).all()):
        raise AssertionError("the sharded global BA left non-finite values")
    out.update(gba_ms=ms_n, gba_1shard_ms=ms_1, gba_peak_mib=peak_n, gba_1shard_peak_mib=peak_1,
               **{f"gba_{k}": v for k, v in gba_gap((Tn, pn, gn), (T1, p1, g1), prob.pt_valid).items()})
    print(f"dryrun 1/3: sharded global BA C={C} P={P} ok | {n_devices}-shard {ms_n:.1f} ms vs "
          f"1-shard {ms_1:.1f} ms ({'CUDA events' if on_card else 'host clock'}; {dev})", flush=True)

    pg = pose_graph_problem(K, dev)
    Sn, ms_pg, peak_pg = _timed(lambda: optimize_pose_graph(pg, mesh=mesh, **PG_KW), dev)
    S1, ms_pg1, peak_pg1 = _timed(lambda: optimize_pose_graph(pg, dense_max_k=0, **PG_KW), dev)
    if not torch.isfinite(Sn.t).all():
        raise AssertionError("the sharded pose graph left non-finite values")
    out.update(pg_ms=ms_pg, pg_1shard_ms=ms_pg1, pg_peak_mib=peak_pg, pg_1shard_peak_mib=peak_pg1,
               pg_diff=float((sim3.to_se3(Sn) - sim3.to_se3(S1)).abs().max()))
    print(f"dryrun 2/3: edge-sharded pose-graph PCG K={K} ok | {n_devices}-shard {ms_pg:.1f} ms vs "
          f"1-shard {ms_pg1:.1f} ms", flush=True)

    if n_devices >= 2:
        devs = mesh.local_devices[:2]
        cfg = split_config()
        ds = SyntheticStereoDataset(cfg.camera, n_frames=SPLIT_FRAMES, speed=0.5, device=devs[0])
        slam = SLAM(cfg, enable_loop_closing=False, devices=devs)
        slam.time_programs = on_card
        for i in range(SPLIT_FRAMES):
            pose, stats = slam.track(*ds.frame(i)[:2])
            if pose is None:
                raise AssertionError(f"the split lost frame {i}: {stats}")
        slam.flush()
        if on_card:
            torch.cuda.synchronize()
        spans = {}
        for name, start, end in slam.program_events:
            spans.setdefault(name, []).append(start.elapsed_time(end))
        frame_ms = float(np.median(slam.frame_times_ms[2:]))
        out.update(split_frame_ms=frame_ms, split_keyframes=slam.n_keyframes,
                   split_span_ms={k: float(np.median(v)) for k, v in spans.items()},
                   split_map_graphs=dict(captures=slam._kf_graphs.captures, replays=slam._kf_graphs.replays))
        print(f"dryrun 3/3: tracker/mapper role split ok (map on {slam.map.kf_Tcw.device}, tracking on "
              f"{slam.last.Tcw.device}) | median frame {frame_ms:.1f} ms over {SPLIT_FRAMES} frames, "
              f"{slam.n_keyframes} keyframes", flush=True)
    return out
