"""The keyframe path's sub-programs one by one (port of the repository's
``profile_kf.py``)::

    python3 -m orb_slam2_ros2_tpu_torch.tools.profile_kf [--warm 30] [--reps 3]

Builds a live map with WARM frames of full SLAM (loop closing on) on the
default world at 0.8 m/frame, then times, each alone, eagerly and as its
own graph (ids as int32 [1] tensors, the map fields it changes written into
the storage inside the graph, as ``frame_graph.KeyframeGraphs`` does):

* the whole ``map_front`` and ``map_tail`` (BA and cull) programs through a
  ``KeyframeGraphs``;
* ``map_front``'s pieces on the map each leaves to the next: insert,
  map-point cull, triangulate, forward fuse, backward fuse, the keyframe
  snapshot, and the frame snapshot of the last frame's points;
* ``map_tail``'s: local BA and the keyframe cull;
* loop add+detect (``loop_closing.LoopGraphs.detect``: the keyframe's BoW
  row written into a copy of the keyframe database and its query);
* the background GBA on a snapshot of the map (``start_global_ba``, not
  timed): one chunk (one GN step, ungated) and the commit, through a
  ``global_ba.GBAGraphs`` as the system replays them, beside the eager
  ``step_global_ba`` and ``commit_global_ba``.  The commit's propagation
  depth is read once, before the timed calls.

Every program that writes runs on a copy of the map (``.to(device,
copy=True)``) that is restored before each call, outside the timed window,
so the map profiled stays the same across reps.
"""

from __future__ import annotations

import torch

from ..mapstate.local_map import local_map_snapshot, local_map_snapshot_frame
from ..mapstate.map_state import insert_keyframe
from ..mapstate.mapping import cull_keyframes, cull_mappoints, fuse_into_keyframe, fuse_keyframe_into_neighbors, \
    triangulate_new_points
from ..pipeline.frame_graph import KeyframeGraphs, donating, id_tensor
from ..pipeline.loop_closing import LoopGraphs
from ..pipeline.system import SLAM
from ..solvers.global_ba import GBAGraphs, _propagate_depth, commit_global_ba, start_global_ba, step_global_ba
from ..solvers.local_ba import local_ba
from . import _frames, _timing

FID = 999   # the frame id JAX's script inserts with


def restorer(storage, source):
    dst, src = list(storage), list(source)
    return lambda: torch._foreach_copy_(dst, src)


def main(argv=None) -> dict:
    ap = _timing.base_parser("profile_kf", __doc__)
    ap.add_argument("--warm", type=int, default=30, help="frames that build the map (JAX: 30)")
    ap.add_argument("--reps", type=int, default=3, help="timed calls; the best is kept (JAX: 3)")
    args = ap.parse_args(argv)
    dev = _timing.resolve_device(args.device)
    cfg = _timing.load_config(args.config)
    frames = _frames.render(cfg, args.warm, dev)
    slam = SLAM(cfg, device=dev)
    tracked = _frames.run_slam(slam, frames)
    _timing.note_slam(slam)
    c, o, t, b, mp = cfg.camera, cfg.orb, cfg.tracking, cfg.ba, cfg.mapping
    cam, cur, pristine = slam.map_cam, slam.last, slam.map
    lvl = dict(scale_factor=o.scale_factor, n_levels=o.n_levels)
    geom = dict(width=c.width, height=c.height, **lvl)
    fid, ref = id_tensor(FID, dev), id_tensor(slam.ref_kf, dev)
    storage = _frames.clone(pristine)
    res = {}

    def time_it(name, program, args_, source, *, graph=True, eager=None, fixed=None):
        r = _timing.bench(program, args_, dev, fixed=(storage,) if fixed is None else fixed, reps=args.reps,
                          restore=restorer(storage, source), eager=eager, graph=graph)
        res[name] = {"ms": r["ms"], "eager_ms": r["eager_ms"]}
        _timing.release(dev)
        return r["out"]

    # the whole programs, replayed by a KeyframeGraphs as the system does
    kfg = KeyframeGraphs(slam.map_front_program, slam.map_tail_program, slam._cull_kfs,
                         slam.bookkeep_program, capture=dev.type == "cuda")
    kf_next = id_tensor(slam._n_kf, dev)
    time_it("map_front", lambda *a: kfg.map_front(storage, *a), (cur.frame, cur.Tcw, cur.mp_ids, fid, kf_next),
            pristine, graph=False, eager=lambda *a: slam.map_front_program(storage, *a), fixed=())
    time_it("map_tail", lambda k: kfg.map_tail(storage, k, True, True), (ref,), pristine, graph=False,
            eager=lambda k: slam.map_tail_program(storage, k, True, True), fixed=())
    del kfg

    # map_front's pieces, each on the map the one before it leaves
    def insert(m, frame, Tcw, mp_ids, fid_):
        return insert_keyframe(m, frame, Tcw, mp_ids, fid_, cam, depth_threshold=c.baseline * t.th_depth,
                               min_covis_weight=mp.min_covis_weight, seed_floor=mp.seed_far_floor, **lvl)

    pieces = {
        "cull_mappoints": lambda m, k: cull_mappoints(m, k, cull_score=mp.mp_cull_score),
        "triangulate": lambda m, k: triangulate_new_points(
            m, k, cam, n_neighbors=mp.n_triangulate_kfs, baseline=c.baseline, rank_gate=mp.triangulation_rank_gate,
            chi2_mono=b.chi2_mono, chi2_stereo=b.chi2_stereo, **lvl),
        "fuse_fwd": lambda m, k: fuse_into_keyframe(m, k, cam, **geom),
        "fuse_bwd": lambda m, k: fuse_keyframe_into_neighbors(
            m, k, cam, n_neighbors=mp.backward_fuse_neighbors, allow_merge=mp.backward_fuse_merge, **geom),
        "local_ba": lambda m, k: local_ba(
            m, k, cam, max_free=b.max_local_ba_kfs, max_fixed=b.max_local_ba_fixed, max_points=b.local_ba_points,
            chi2_mono=b.chi2_mono, chi2_stereo=b.chi2_stereo, lam=b.lm_lambda_init, scale_factor=o.scale_factor,
            phase_iters=tuple(b.local_ba_phase_iters)),
        "cull_keyframes": lambda m, k: cull_keyframes(m, k, redundancy=mp.kf_cull_ratio,
                                                      n_candidates=mp.kf_cull_candidates),
    }
    nbytes = {}

    def writes(name, fn):
        """``fn(map, *ins) -> new map`` as a program over (*ins, storage)."""
        return donating(lambda m, *a: (fn(m, *a),), nbytes, name)

    new_kf = time_it("insert_keyframe", donating(insert, nbytes, "insert"),
                     (cur.frame, cur.Tcw, cur.mp_ids, fid), pristine,
                     eager=lambda *a: insert(*a[-1:], *a[:-1]))[0]
    kf = id_tensor(new_kf, dev)
    # the chain the front program runs, eagerly on copies: after insert,
    # triangulation, the forward fuse and the backward fuse
    after = {"insert": insert(_frames.clone(pristine), cur.frame, cur.Tcw, cur.mp_ids, fid)[0]}
    after["triangulate"] = pieces["triangulate"](_frames.clone(after["insert"]), kf)
    after["fuse_fwd"] = pieces["fuse_fwd"](_frames.clone(after["triangulate"]), kf)
    after["fuse_bwd"] = pieces["fuse_bwd"](_frames.clone(after["fuse_fwd"]), kf)
    on = {"cull_mappoints": "insert", "triangulate": "insert", "fuse_fwd": "triangulate", "fuse_bwd": "fuse_fwd",
          "local_ba": "fuse_bwd", "cull_keyframes": "fuse_bwd"}
    for name in ("cull_mappoints", "triangulate", "fuse_fwd", "fuse_bwd"):
        time_it(name, writes(name, pieces[name]), (kf,), after[on[name]],
                eager=lambda k, m, fn=pieces[name]: fn(m, k))
    snap_kw = dict(max_kfs=t.max_local_keyframes, max_mps=t.max_local_mappoints)
    time_it("snapshot_kf", lambda k, m: local_map_snapshot(m, k, **snap_kw), (kf,), after["fuse_bwd"])
    time_it("snapshot_frame", lambda ids, m: local_map_snapshot_frame(m, ids, **snap_kw), (cur.mp_ids,),
            after["fuse_bwd"])
    for name in ("local_ba", "cull_keyframes"):
        time_it(name, writes(name, pieces[name]), (kf,), after[on[name]],
                eager=lambda k, m, fn=pieces[name]: fn(m, k))

    # loop add+detect into a copy of the database
    lc = slam.loop_closer
    if lc is not None:
        db = _frames.clone(lc.db)
        lg = LoopGraphs(cfg, lc.vocab, capture=dev.type == "cuda")
        keep = restorer(db, lc.db)

        r = _timing.bench(lambda k: lg.detect(pristine, db, k), (ref,), dev, reps=args.reps, graph=False, restore=keep,
                          eager=lambda k: lg.eager["detect"](pristine, db, k))
        res["loop_add_detect"] = {"ms": r["ms"], "eager_ms": r["eager_ms"]}
        del lg, db

    # the background GBA's chunk and commit on a snapshot of the map
    pend = start_global_ba(pristine, o.scale_factor)
    solver = dict(pcg_iters=b.pcg_iters, chi2_mono=b.chi2_mono, chi2_stereo=b.chi2_stereo)
    gba = GBAGraphs(n_iters=1, capture=dev.type == "cuda", **solver)
    capacity = (pristine.kf_capacity, pristine.mp_capacity)
    r = _timing.bench(lambda p: gba.step(p, cam, robust_after=1, capacity=capacity), (pend,), dev, reps=args.reps,
                      graph=False, eager=lambda p: step_global_ba(p, cam, n_iters=1, robust_after=1, **solver))
    res["gba_chunk"] = {"ms": r["ms"], "eager_ms": r["eager_ms"]}
    depth = _propagate_depth(pristine, pend)
    time_it("gba_commit", lambda p: gba.commit(storage, p, propagate_depth=depth), (pend,), pristine, graph=False,
            eager=lambda p: commit_global_ba(storage, p, propagate_depth=depth), fixed=())
    del gba, pend
    out = {"warm": args.warm, "tracked": tracked, "keyframes": slam.n_keyframes, "mappoints": slam.n_mappoints,
           "reps": args.reps, "programs": res}
    del slam, storage, after
    _timing.release(dev)
    return _timing.emit("profile_kf", dev, out)


if __name__ == "__main__":
    main()
