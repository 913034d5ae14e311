"""Whole-map global bundle adjustment over the device-resident map.

Port of ``orb_slam2_ros2_tpu/solvers/global_ba.py`` (reference
Optimizer::globalOptimization + LoopClosing::runGlobalBA,
src/Optimizer.cc:934-1043, src/LoopClosing.cc:92-169).  The map's bounded
reverse observation index (``mp_obs_kf`` / ``mp_obs_feat``) is the per-point
edge layout of the PCG-Schur engine, so extraction is gathering.

- ``global_ba``: the synchronous whole solve.
- ``start_global_ba`` / ``step_global_ba`` / ``commit_global_ba``: the
  background mode the SLAM loop runs after a loop closure — a snapshot
  problem solved in one-GN-step chunks on idle frames, then committed onto
  the live map with the reference's spanning-tree propagation for the
  keyframes and points created during the solve (LoopClosing.cc:109-166).
  ``start`` reads back the allocation watermarks and the view size and
  copies every buffer it keeps; a chunk reads nothing back.

Both take a device ``mesh`` (``parallel/mesh.py``): the solve then shards
the points and cameras over it (``pcg_ba.solve_global_ba_sharded``); the
background solve pads and splits its snapshot once, on its first chunk,
and keeps the shards in ``PendingGBA.shards`` (JAX caches the sharded chunk
program instead).

``GBAGraphs`` runs the chunk and the commit as captured CUDA graphs, the
counterparts of JAX's jitted ``_step_jit`` / ``_sharded_step_jit`` and
``_commit_jit``: the chunk unsharded or over a mesh that
``Mesh.capturable`` admits (one process, every local slot on one device),
the commit under any mesh (it is not sharded).  Over any other mesh
``GBAGraphs.step`` runs the chunk as ``step_global_ba``, eagerly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..geometry import se3
from ..geometry.camera import CameraParams
from ..mapstate.map_state import MapState, copy_into
from ..pipeline.frame_graph import StepGraph, held_addresses, id_tensor, tree_leaves
from .pcg_ba import (
    GlobalBAProblem,
    PointBAProblem,
    _pad_global,
    _shard_global,
    global_ba_phase,
    pad_global_to,
    point_to_global,
    solve_global_ba,
    solve_global_ba_sharded,
)


def extract_global_problem(state: MapState, scale_factor: float = 1.2) -> PointBAProblem:
    """Every map point with the observations that still point back at it
    (fuse and cull may have repointed a slot); keyframe 0 is the gauge."""
    K, M = state.kf_capacity, state.mp_capacity
    N = state.kf_uv.shape[1]
    dev = state.kf_Tcw.device
    obs_kf = state.mp_obs_kf                                       # [M, O]
    ok = (obs_kf >= 0) & state.mp_valid[:, None]
    kfc = obs_kf.clamp(0, K - 1).long()
    ftc = state.mp_obs_feat.clamp(0, N - 1).long()
    backlink = state.kf_mp_idx[kfc, ftc] == torch.arange(M, device=dev)[:, None]
    ok = ok & backlink & state.kf_valid[kfc]
    inv_sigma2 = torch.pow(1.0 / (scale_factor * scale_factor), state.kf_octave[kfc, ftc].float())
    return PointBAProblem(
        cam_Tcw=state.kf_Tcw,
        cam_free=state.kf_valid & (torch.arange(K, device=dev) != 0),
        pt_pos=state.mp_pos,
        pt_valid=state.mp_valid & ok.any(dim=1),
        obs_cam=torch.where(ok, obs_kf, -1),
        obs_uv=state.kf_uv[kfc, ftc],
        obs_right_u=torch.where(ok, state.kf_right_u[kfc, ftc], -1.0),
        obs_inv_sigma2=inv_sigma2,
        obs_valid=ok,
    )


def global_ba(
    state: MapState,
    cam: CameraParams,
    *,
    scale_factor: float = 1.2,
    phase_iters=(5, 5),
    pcg_iters: int = 40,
    lam: float = 0.1,
    mesh=None,
    axis: str = "ba",
) -> MapState:
    """Run the global BA (sharded over ``mesh`` when given) and commit its
    poses and points."""
    prob = extract_global_problem(state, scale_factor)
    if mesh is not None:
        Tcw, pts, _ = solve_global_ba_sharded(cam, prob, mesh, axis=axis, phase_iters=phase_iters,
                                              pcg_iters=pcg_iters, lam=lam)
        dev = state.kf_Tcw.device
        Tcw, pts = Tcw.to(dev), pts.to(dev)
    else:
        Tcw, pts, _ = solve_global_ba(cam, prob, phase_iters=phase_iters, pcg_iters=pcg_iters, lam=lam)
    return state._replace(
        kf_Tcw=torch.where(state.kf_valid[:, None, None], Tcw, state.kf_Tcw),
        mp_pos=torch.where(prob.pt_valid[:, None], pts, state.mp_pos),
    )


# --------------------------------------------------------------------------
# background GBA (chunked solve + commit)
# --------------------------------------------------------------------------

class PendingGBA(NamedTuple):
    """A global BA in flight: the snapshot problem, the evolving iterate and
    the snapshot's allocation watermarks (host ints)."""

    prob: GlobalBAProblem
    Tcw: torch.Tensor          # f32[K, 4, 4] evolving camera iterate
    ptsT: torch.Tensor         # f32[3, M] evolving point iterate
    pt_in_ba: torch.Tensor     # bool[M] points the solve optimizes
    snap_next_kf: int
    snap_next_mp: int
    chunks_done: int
    # (mesh, this process's shards of the padded problem): made by the
    # first sharded chunk and kept for the rest of the solve
    shards: Optional[tuple] = None


def _watermarks(n_kf: int, n_mp: int, K: int, M: int):
    """Live slots rounded up to 64 keyframes and 1024 points (bump
    allocation is contiguous, so the ids below the watermarks cover every
    live slot), within the capacities."""
    return (min(max(((n_kf + 63) // 64) * 64, 64), K),
            min(max(((n_mp + 1023) // 1024) * 1024, 1024), M))


def _compact_global(prob: GlobalBAProblem, n_kf: int, n_mp: int) -> GlobalBAProblem:
    """Slice a GlobalBAProblem to the live watermarks (the stores are
    capacity-padded: solving over the padding costs >10× the work)."""
    K, M = _watermarks(n_kf, n_mp, prob.cam_Tcw.shape[0], prob.pt_pos.shape[0])
    return GlobalBAProblem(
        cam_Tcw=prob.cam_Tcw[:K], cam_free=prob.cam_free[:K],
        pt_pos=prob.pt_pos[:M], pt_valid=prob.pt_valid[:M],
        pm_cam=prob.pm_cam[:, :M], pm_uv=prob.pm_uv[:, :, :M],
        pm_right_u=prob.pm_right_u[:, :M],
        pm_inv_sigma2=prob.pm_inv_sigma2[:, :M], pm_valid=prob.pm_valid[:, :M],
        cm_pt=prob.cm_pt[:, :K], cm_uv=prob.cm_uv[:, :, :K],
        cm_right_u=prob.cm_right_u[:, :K],
        cm_inv_sigma2=prob.cm_inv_sigma2[:, :K], cm_valid=prob.cm_valid[:, :K],
    )


def _compact_points(prob: PointBAProblem, K: int, M: int) -> PointBAProblem:
    return PointBAProblem(
        cam_Tcw=prob.cam_Tcw[:K], cam_free=prob.cam_free[:K],
        pt_pos=prob.pt_pos[:M], pt_valid=prob.pt_valid[:M], obs_cam=prob.obs_cam[:M],
        obs_uv=prob.obs_uv[:M], obs_right_u=prob.obs_right_u[:M],
        obs_inv_sigma2=prob.obs_inv_sigma2[:M], obs_valid=prob.obs_valid[:M],
    )


def start_global_ba(state: MapState, scale_factor: float = 1.2) -> PendingGBA:
    """Snapshot the map into a chunked-GBA state (no solving yet).

    The per-point problem is cut to the watermarks before the camera-major
    view is built: no edge refers to a slot above them, so the view equals
    that of the whole problem cut afterwards (the JAX order).  The snapshot
    owns every buffer: the live map moves on while the chunks run."""
    n_kf, n_mp = int(state.next_kf), int(state.next_mp)
    K, M = _watermarks(n_kf, n_mp, state.kf_capacity, state.mp_capacity)
    pprob = _compact_points(extract_global_problem(state, scale_factor), K, M)
    prob = GlobalBAProblem(*(a.clone() for a in point_to_global(pprob)))
    return PendingGBA(
        prob=prob, Tcw=prob.cam_Tcw, ptsT=prob.pt_pos.T.contiguous(),
        pt_in_ba=pprob.pt_valid.clone(), snap_next_kf=n_kf, snap_next_mp=n_mp, chunks_done=0,
    )


def step_global_ba(
    pending: PendingGBA,
    cam: CameraParams,
    *,
    n_iters: int = 1,
    pcg_iters: int = 40,
    lam: float = 0.1,
    chi2_mono: float = 5.991,
    chi2_stereo: float = 7.815,
    robust_after: int = 1,
    mesh=None,
    axis: str = "ba",
) -> PendingGBA:
    """Advance the solve by one chunk of ``n_iters`` damped-GN steps; chunks
    from ``robust_after`` on gate observations by the χ² of their entry
    iterate.  With a ``mesh`` the chunk runs sharded: the snapshot is padded
    and split on the first sharded chunk and kept in ``shards``; the point
    iterate is split and gathered around each chunk.  Reads nothing back."""
    kw = dict(chi2_mono=chi2_mono, chi2_stereo=chi2_stereo, n_iters=n_iters, pcg_iters=pcg_iters,
              lam=lam, robust_gate=pending.chunks_done >= robust_after)
    if mesh is None:
        Tcw, ptsT = global_ba_phase(cam, pending.prob, pending.Tcw, pending.ptsT, **kw)
        return pending._replace(Tcw=Tcw, ptsT=ptsT, chunks_done=pending.chunks_done + 1)
    if mesh.axis != axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")
    if pending.shards is None or pending.shards[0] is not mesh:
        pending = pending._replace(shards=(mesh, _shard_global(_pad_global(pending.prob, mesh.size), mesh)))
    shards = pending.shards[1]
    K0, M0 = pending.Tcw.shape[0], pending.ptsT.shape[1]
    Kp = shards[0].cam_Tcw.shape[0]
    Mp = shards[0].pt_pos.shape[0] * mesh.size
    eye = torch.eye(4, dtype=pending.Tcw.dtype, device=pending.Tcw.device).expand(Kp - K0, 4, 4)
    Tcw = torch.cat([pending.Tcw, eye]).to(mesh.device)
    ptsT = torch.cat([pending.ptsT, pending.ptsT.new_zeros((3, Mp - M0))], dim=1)
    Tcw, ptsT = global_ba_phase(cam, shards, Tcw, mesh.split(ptsT), axis=mesh, **kw)
    dev = pending.Tcw.device
    return pending._replace(Tcw=Tcw[:K0].to(dev), ptsT=mesh.all_gather(ptsT)[:, :M0].to(dev),
                            chunks_done=pending.chunks_done + 1)


def _commit_inputs(state: MapState, pending: PendingGBA):
    """The solve's iterate padded to the live map's capacities, which may
    have grown since the snapshot: (Tcw_gba [K, 4, 4], pts_gba [M, 3],
    in_ba [M])."""
    K, M = state.kf_capacity, state.mp_capacity
    Tcw_gba, pts_gba, in_ba = pending.Tcw, pending.ptsT.T, pending.pt_in_ba
    if Tcw_gba.shape[0] < K:
        eye = torch.eye(4, dtype=torch.float32, device=Tcw_gba.device)
        Tcw_gba = torch.cat([Tcw_gba, eye.expand(K - Tcw_gba.shape[0], 4, 4)])
    if pts_gba.shape[0] < M:
        pad = M - pts_gba.shape[0]
        pts_gba = torch.cat([pts_gba, pts_gba.new_zeros((pad, 3))])
        in_ba = torch.cat([in_ba, in_ba.new_zeros((pad,))])
    return Tcw_gba, pts_gba, in_ba


def _propagate_depth(state: MapState, pending: PendingGBA) -> int:
    """The keyframes created since the snapshot, at least 4 (reads back
    ``next_kf``, as JAX's ``commit_global_ba`` does)."""
    return max(4, int(state.next_kf) - pending.snap_next_kf)


def commit_global_ba(state: MapState, pending: PendingGBA, *,
                     propagate_depth: Optional[int] = None) -> MapState:
    """Commit a finished chunked GBA onto the live map, which may hold
    keyframes and points created after the snapshot (LoopClosing.cc:109-166):
    snapshot keyframes take their optimized poses; later keyframes follow
    their spanning-tree parent's correction (``propagate_depth`` rounds,
    by default the number of keyframes created since the snapshot, at least
    4); optimized points take their positions, the others ride their
    reference keyframe's correction.  Reads back ``next_kf``."""
    if propagate_depth is None:
        propagate_depth = _propagate_depth(state, pending)
    return _commit_impl(state, *_commit_inputs(state, pending), pending.snap_next_kf,
                        pending.snap_next_mp, propagate_depth)


def _commit_impl(state: MapState, Tcw_gba, pts_gba, pt_in_ba, snap_next_kf, snap_next_mp,
                 propagate_depth, rounds: Optional[int] = None) -> MapState:
    """The commit.  The watermarks and the depth are host ints, or int32 [1]
    tensors (JAX traces them) with ``rounds`` ≥ the depth: the propagation
    then runs ``rounds`` rounds, those at or past the depth masked — JAX's
    ``fori_loop`` with a traced trip count, as a fixed program."""
    K, M = state.kf_capacity, state.mp_capacity
    dev = state.kf_Tcw.device
    old_kf = (torch.arange(K, device=dev) < snap_next_kf) & state.kf_valid
    Tcw_cur = state.kf_Tcw
    Tcw_out = torch.where(old_kf[:, None, None], Tcw_gba, Tcw_cur)
    corrected = old_kf

    # spanning-tree propagation: child_new = child_cur · inv(parent_cur) · parent_new
    parent = state.kf_parent.clamp(0, K - 1).long()
    has_parent = state.kf_valid & (state.kf_parent >= 0)
    inv_parent_cur = se3.inverse(Tcw_cur[parent])
    for r in range(propagate_depth if rounds is None else rounds):
        can = ~corrected & has_parent & corrected[parent]
        if rounds is not None:
            can = can & (propagate_depth > r)
        prop = Tcw_cur @ (inv_parent_cur @ Tcw_out[parent])
        Tcw_out = torch.where(can[:, None, None], prop, Tcw_out)
        corrected = corrected | can

    # optimized points take the solve's positions; the rest ride their
    # reference keyframe's correction
    in_ba = (torch.arange(M, device=dev) < snap_next_mp) & state.mp_valid & pt_in_ba
    mp_pos = torch.where(in_ba[:, None], pts_gba, state.mp_pos)
    ref = state.mp_ref_kf.clamp(0, K - 1).long()
    ref_ok = state.mp_valid & ~in_ba & (state.mp_ref_kf >= 0) & corrected[ref]
    T_ref = Tcw_cur[ref]
    p_cam = torch.einsum("mij,mj->mi", T_ref[:, :3, :3], state.mp_pos) + T_ref[:, :3, 3]
    Twc_new = se3.inverse(Tcw_out[ref])
    p_new = torch.einsum("mij,mj->mi", Twc_new[:, :3, :3], p_cam) + Twc_new[:, :3, 3]
    mp_pos = torch.where(ref_ok[:, None], p_new, mp_pos)
    return state._replace(kf_Tcw=Tcw_out, mp_pos=mp_pos)


# --------------------------------------------------------------------------
# the chunk and the commit as CUDA graphs
# --------------------------------------------------------------------------

def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


class _Bucket(NamedTuple):
    key: tuple                 # (K, M, N, O, device, mesh): the padded shapes and the mesh
    prob: GlobalBAProblem      # the static problem the graph reads
    shards: Optional[list]     # with a mesh: its shards, views of ``prob``
    step: StepGraph
    source: GlobalBAProblem    # the snapshot copied into ``prob`` last


class GBAGraphs:
    """The background GBA as CUDA graphs: the chunk (``global_ba_phase`` of
    ``n_iters`` GN steps, unsharded or over a capturable mesh) and the
    commit (``_commit_impl``), each a ``StepGraph`` (``capture=False`` runs
    the same static-buffer wrappers eagerly: the CPU).

    The chunk's graph is keyed on a bucket of the snapshot's shapes — its
    watermarks rounded up to powers of two within the map's capacities, and
    the camera-major feature capacity to a power of two ≥ 8 — and on the
    mesh, so the snapshots of later closures reuse it; the snapshot is
    padded to the bucket (padded cameras fixed at the identity, padded
    points and edges invalid) and copied into the bucket's static problem
    once, at its first chunk.  A chunk then copies in only the iterate, the
    gate as a bool [1] (``robust_gate``: one graph serves the ungated and
    the gated chunks) and the camera.  Over a mesh the bucket's cameras
    and points are further rounded up to multiples of its size, and the
    static problem is sharded once into views of itself (``_shard_global``
    with ``views``), which the graph reads at their addresses; the point
    iterate is split inside the graph and gathered there.  Only the newest
    bucket's graph is kept.

    The commit takes the watermarks and the propagation depth as int32 [1]
    tensors and runs the depth rounded up to a power of two rounds, those
    past the depth masked (a graph per rounding); it writes ``kf_Tcw`` and
    ``mp_pos`` into the map storage inside the graph, as the keyframe graphs
    do (``copied_bytes`` counts the bytes).  A storage of other shapes needs
    ``clear()`` first.  ``tracer`` (a ``pipeline.trace.Tracer``) names the
    steps' graph ``gba``."""

    def __init__(self, *, n_iters: int = 1, pcg_iters: int = 40, lam: float = 0.1,
                 chi2_mono: float = 5.991, chi2_stereo: float = 7.815, capture: bool = True):
        self.solver = dict(n_iters=n_iters, pcg_iters=pcg_iters, lam=lam, chi2_mono=chi2_mono,
                           chi2_stereo=chi2_stereo)
        self.capture = capture
        self.tracer = None
        self._bucket: Optional[_Bucket] = None
        self._commits: dict = {}     # rounds -> StepGraph
        self._map_ptrs: Optional[tuple] = None
        self._nbytes: dict = {}      # rounds -> bytes a commit writes into the storage
        self.copied_bytes = 0
        self.snapshot_loads = 0      # snapshots copied into a bucket's statics
        # ("chunk", (K, M, N, O), shards) / ("commit", rounds) of each graph
        self.capture_log: list = []
        # replays (calls of the static-buffer wrappers with capture=False)
        # since construction, dropped graphs' included
        self.chunk_replays = 0
        self.commit_replays = 0
        self.eager_chunks = 0        # chunks over a mesh that is not capturable

    @property
    def captures(self) -> int:
        return len(self.capture_log)

    @property
    def replays(self) -> int:
        return self.chunk_replays + self.commit_replays

    def clear(self) -> None:
        """Drop every graph (the map storage was re-allocated)."""
        self._bucket = None
        self._commits.clear()
        self._map_ptrs = None

    @staticmethod
    def bucket(pending: PendingGBA, capacity: tuple) -> tuple:
        """(K, M, N) of the padded problem: the snapshot's watermarks rounded
        up to powers of two within ``capacity`` (the map's keyframe and
        point capacities), the feature capacity to a power of two ≥ 8."""
        K0, M0 = pending.Tcw.shape[0], pending.ptsT.shape[1]
        N0 = pending.prob.cm_pt.shape[0]
        return (min(_pow2(K0), max(K0, capacity[0])), min(_pow2(M0), max(M0, capacity[1])),
                max(8, _pow2(N0)))

    def _chunk_program(self, mesh):
        solver = self.solver
        if mesh is None:
            def chunk(Tcw, ptsT, gate, cam, prob):
                return global_ba_phase(cam, prob, Tcw, ptsT, robust_gate=gate, **solver)
        else:
            def chunk(Tcw, ptsT, gate, cam, shards):
                Tcw, ptsT = global_ba_phase(cam, shards, Tcw, mesh.split(ptsT), robust_gate=gate,
                                            axis=mesh, **solver)
                return Tcw, mesh.all_gather(ptsT)

        return chunk

    def step(self, pending: PendingGBA, cam: CameraParams, *, robust_after: int,
             capacity: tuple, mesh=None) -> PendingGBA:
        """``step_global_ba`` through the bucket's graph, unsharded or over
        a ``capturable`` ``mesh`` (the graph then runs on the mesh's
        device); over any other mesh ``step_global_ba`` itself, eagerly.
        ``capacity`` is the live map's (kf_capacity, mp_capacity)."""
        if mesh is not None and not mesh.capturable:
            self.eager_chunks += 1
            return step_global_ba(pending, cam, robust_after=robust_after, mesh=mesh, axis=mesh.axis,
                                  **self.solver)
        K0, M0 = pending.Tcw.shape[0], pending.ptsT.shape[1]
        K, M, N = self.bucket(pending, capacity)
        dev = pending.Tcw.device if mesh is None else mesh.device
        if mesh is not None:
            K, M = K + (-K) % mesh.size, M + (-M) % mesh.size
        key = (K, M, N, pending.prob.pm_cam.shape[0], dev, mesh)
        b = self._bucket
        if b is None or b.key != key:
            self._bucket = None   # the old bucket's graph goes first
            prob = GlobalBAProblem(*(t.to(dev, copy=True) for t in pad_global_to(pending.prob, K, M, N)))
            shards = None if mesh is None else _shard_global(prob, mesh, views=True)
            b = self._bucket = _Bucket(key, prob, shards,
                                       StepGraph(self._chunk_program(mesh), capture=self.capture)
                                       .traced(self.tracer, "gba"), pending.prob)
            self.snapshot_loads += 1
        elif b.source is not pending.prob:
            # a new snapshot of this bucket: into the statics, at their addresses
            torch._foreach_copy_(tree_leaves(b.prob), tree_leaves(pad_global_to(pending.prob, K, M, N)))
            b = self._bucket = b._replace(source=pending.prob)
            self.snapshot_loads += 1
        Tcw = torch.cat([pending.Tcw, torch.eye(4, dtype=pending.Tcw.dtype, device=pending.Tcw.device)
                         .expand(K - K0, 4, 4)]).to(dev)
        ptsT = torch.cat([pending.ptsT, pending.ptsT.new_zeros((3, M - M0))], dim=1).to(dev)
        gate = torch.full((1,), pending.chunks_done >= robust_after, dtype=torch.bool, device=dev)
        captures, replays = b.step.captures, b.step.replays
        Tcw, ptsT = b.step(Tcw, ptsT, gate, CameraParams(*(t.to(dev) for t in cam)),
                           fixed=(b.prob if mesh is None else b.shards,))
        if b.step.captures > captures:
            self.capture_log.append(("chunk", key[:4], 1 if mesh is None else mesh.size))
        self.chunk_replays += b.step.replays - replays
        out = pending.Tcw.device
        return pending._replace(Tcw=Tcw[:K0].to(out), ptsT=ptsT[:, :M0].to(out),
                                chunks_done=pending.chunks_done + 1)

    def commit(self, storage: MapState, pending: PendingGBA, *,
               propagate_depth: Optional[int] = None) -> None:
        """``commit_global_ba`` into ``storage`` (the map the graphs read):
        its ``kf_Tcw`` and ``mp_pos`` are written in place.  Reads back
        ``next_kf`` unless ``propagate_depth`` is given."""
        self._map_ptrs = held_addresses(self._map_ptrs, storage, "the map storage", "GBA commit graph")
        if propagate_depth is None:
            propagate_depth = _propagate_depth(storage, pending)
        rounds = _pow2(propagate_depth)
        step = self._commits.get(rounds)
        if step is None:
            nbytes = self._nbytes

            def donated(Tcw_gba, pts_gba, in_ba, snap_kf, snap_mp, depth, state):
                new = _commit_impl(state, Tcw_gba, pts_gba, in_ba, snap_kf, snap_mp, depth, rounds=rounds)
                nbytes[rounds] = copy_into(state, new)
                return ()

            step = self._commits[rounds] = StepGraph(donated, capture=self.capture).traced(self.tracer, "gba")
        dev = storage.kf_Tcw.device
        captures, replays = step.captures, step.replays
        step(*_commit_inputs(storage, pending), id_tensor(pending.snap_next_kf, dev),
             id_tensor(pending.snap_next_mp, dev), id_tensor(propagate_depth, dev), fixed=(storage,))
        if step.captures > captures:
            self.capture_log.append(("commit", rounds))
        self.commit_replays += step.replays - replays
        self.copied_bytes += self._nbytes[rounds]
