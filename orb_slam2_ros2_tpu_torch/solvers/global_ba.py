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

The point/camera-sharded chunk waits for the multi-GPU item of the port
queue.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..geometry import se3
from ..geometry.camera import CameraParams
from ..mapstate.map_state import MapState
from .pcg_ba import GlobalBAProblem, PointBAProblem, global_ba_phase, point_to_global, solve_global_ba


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
) -> MapState:
    """Run the global BA and commit its poses and points."""
    if mesh is not None:
        raise NotImplementedError("the sharded global BA is not ported yet (ROADMAP port queue: multi-GPU)")
    prob = extract_global_problem(state, scale_factor)
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
) -> PendingGBA:
    """Advance the solve by one chunk of ``n_iters`` damped-GN steps; chunks
    from ``robust_after`` on gate observations by the χ² of their entry
    iterate.  Reads nothing back."""
    if mesh is not None:
        raise NotImplementedError("the sharded global BA is not ported yet (ROADMAP port queue: multi-GPU)")
    Tcw, ptsT = global_ba_phase(
        cam, pending.prob, pending.Tcw, pending.ptsT, chi2_mono=chi2_mono, chi2_stereo=chi2_stereo,
        n_iters=n_iters, pcg_iters=pcg_iters, lam=lam,
        robust_gate=pending.chunks_done >= robust_after,
    )
    return pending._replace(Tcw=Tcw, ptsT=ptsT, chunks_done=pending.chunks_done + 1)


def commit_global_ba(state: MapState, pending: PendingGBA, *,
                     propagate_depth: Optional[int] = None) -> MapState:
    """Commit a finished chunked GBA onto the live map, which may hold
    keyframes and points created after the snapshot (LoopClosing.cc:109-166):
    snapshot keyframes take their optimized poses; later keyframes follow
    their spanning-tree parent's correction (``propagate_depth`` rounds,
    by default the number of keyframes created since the snapshot, at least
    4); optimized points take their positions, the others ride their
    reference keyframe's correction.  Reads back ``next_kf``."""
    K, M = state.kf_capacity, state.mp_capacity
    Tcw_gba, pts_gba, in_ba = pending.Tcw, pending.ptsT.T, pending.pt_in_ba
    if Tcw_gba.shape[0] < K:
        eye = torch.eye(4, dtype=torch.float32, device=Tcw_gba.device)
        Tcw_gba = torch.cat([Tcw_gba, eye.expand(K - Tcw_gba.shape[0], 4, 4)])
    if pts_gba.shape[0] < M:
        pad = M - pts_gba.shape[0]
        pts_gba = torch.cat([pts_gba, pts_gba.new_zeros((pad, 3))])
        in_ba = torch.cat([in_ba, in_ba.new_zeros((pad,))])
    if propagate_depth is None:
        propagate_depth = max(4, int(state.next_kf) - pending.snap_next_kf)
    return _commit_impl(state, Tcw_gba, pts_gba, in_ba, pending.snap_next_kf,
                        pending.snap_next_mp, propagate_depth)


def _commit_impl(state: MapState, Tcw_gba, pts_gba, pt_in_ba, snap_next_kf: int,
                 snap_next_mp: int, propagate_depth: int) -> MapState:
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
    for _ in range(propagate_depth):
        can = ~corrected & has_parent & corrected[parent]
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
