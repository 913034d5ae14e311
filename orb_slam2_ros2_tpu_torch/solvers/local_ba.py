"""Local bundle adjustment over the device map (port of
``orb_slam2_ros2_tpu/solvers/local_ba.py``; reference
Optimizer::OptimizeLocalMap, src/Optimizer.cc:225-442).

Free vertices are the new keyframe and its top covisible neighbours (never
keyframe 0, the gauge anchor), landmarks their map points, fixed anchors
the other keyframes observing those points.  The window is extracted into
the per-point layout and solved by ``schur_ba.solve_ba_points``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..geometry.camera import CameraParams
from ..mapstate.map_state import MapState, _set_drop_2d, kf_index
from ..utils import count_into, mask_from_ids, set_drop, topk_bounded
from .pcg_ba import PointBAProblem, _chi2_point
from .schur_ba import solve_ba_points

INT32_MAX = (1 << 31) - 1

# host-side count of local BA runs (incremented once per ``local_ba`` call)
local_ba_runs = 0


def extract_window_points(
    state: MapState,
    kf_id,
    *,
    max_free: int,
    max_fixed: int,
    max_points: int,
    scale_factor: float = 1.2,
):
    """The local BA problem around ``kf_id`` in per-point layout.  Returns
    (problem, cam_ids [C], pt_ids [P], obs_kf [P, O], obs_feat [P, O]) — the
    global ids the results and edge removals are written back through."""
    K, M = state.kf_capacity, state.mp_capacity
    N = state.kf_uv.shape[1]
    dev = state.kf_Tcw.device
    arangeK = torch.arange(K, dtype=torch.int32, device=dev)

    # free cameras: top covisible neighbours, the keyframe itself first
    k = kf_index(kf_id, dev)
    w = state.covis.index_select(0, k)[0] * state.kf_valid.to(torch.int32)
    w = w.index_fill(0, k, INT32_MAX)
    wv, free_ids = topk_bounded(w, max_free)
    free_ok = wv > 0
    free_ids = torch.where(free_ok, free_ids, -1)
    free_mask_k = mask_from_ids(free_ids, K)

    # landmarks: the free cameras' points, most recent first
    rows = torch.where(free_ok[:, None], state.kf_mp_idx[free_ids.clamp(0, K - 1)], -1)
    mp_mask = mask_from_ids(rows, M) & state.mp_valid
    score = torch.where(mp_mask, 1 + torch.arange(M, dtype=torch.int32, device=dev), 0)
    top, pt_ids = topk_bounded(score, max_points)
    pt_ok = top > 0
    pt_ids = torch.where(pt_ok, pt_ids, -1)
    ptc = pt_ids.clamp(0, M - 1)

    # their observations; each must still point back at its map point
    obs_kf = torch.where(pt_ok[:, None], state.mp_obs_kf[ptc], -1)       # [P, O]
    obs_feat = state.mp_obs_feat[ptc]
    kfc = obs_kf.clamp(0, K - 1).long()
    ftc = obs_feat.clamp(0, N - 1).long()
    obs_ok = ((obs_kf >= 0) & state.kf_valid[kfc]
              & (state.kf_mp_idx[kfc, ftc] == ptc[:, None]) & pt_ok[:, None])

    # fixed cameras: the other observers of the landmarks
    fixed_mask = mask_from_ids(torch.where(obs_ok, obs_kf, K), K) & state.kf_valid & ~free_mask_k
    ftop, fixed_ids = topk_bounded(torch.where(fixed_mask, 1 + arangeK, 0), max_fixed)
    fixed_ok = ftop > 0
    fixed_ids = torch.where(fixed_ok, fixed_ids, -1)

    cam_ids = torch.cat([free_ids, fixed_ids])
    cam_ok = torch.cat([free_ok, fixed_ok])
    # gauge: keyframe 0 is never free
    cam_free = torch.cat([free_ok & (free_ids != 0), torch.zeros_like(fixed_ok)])
    C = cam_ids.shape[0]
    inv_cam = set_drop(torch.full((K,), -1, dtype=torch.int32, device=dev),
                       torch.where(cam_ok, cam_ids, K), torch.arange(C, dtype=torch.int32, device=dev))
    obs_cam = torch.where(obs_ok, inv_cam[kfc], -1)
    # a landmark observed by a keyframe left out of the window (the fixed
    # anchors are bounded) is held where it is: moved by the window's
    # observers alone, it would leave the others (ORB-SLAM2 holds every
    # observer fixed, Optimizer.cc:268-291); its observations still bind
    # the free cameras
    seen_whole = ~(obs_ok & (obs_cam < 0)).any(dim=1)
    obs_ok = obs_ok & (obs_cam >= 0)

    prob = PointBAProblem(
        cam_Tcw=state.kf_Tcw[cam_ids.clamp(0, K - 1)],
        cam_free=cam_free,
        pt_pos=state.mp_pos[ptc],
        pt_valid=pt_ok & obs_ok.any(dim=1) & seen_whole,
        obs_cam=torch.where(obs_ok, obs_cam, -1),
        obs_uv=state.kf_uv[kfc, ftc],
        obs_right_u=torch.where(obs_ok, state.kf_right_u[kfc, ftc], -1.0),
        obs_inv_sigma2=torch.pow(1.0 / (scale_factor * scale_factor), state.kf_octave[kfc, ftc].float()),
        obs_valid=obs_ok,
    )
    return prob, cam_ids, pt_ids, obs_kf, obs_feat


def local_ba(
    state: MapState,
    kf_id,
    cam: CameraParams,
    *,
    max_free: int = 16,
    max_fixed: int = 32,
    max_points: int = 8192,
    chi2_mono: float = 5.991,
    chi2_stereo: float = 7.815,
    phase_iters: Tuple[int, int] = (3, 5),
    lam: float = 1e-3,
    scale_factor: float = 1.2,
    erase_in_anchors: bool = False,
) -> MapState:
    """Run local BA around ``kf_id`` and write the free poses and the points
    back; observations at more than twice the χ² gate after the solve are
    removed from both indexes (Optimizer.cc:391-430): those of the free
    keyframes, as JAX, and with ``erase_in_anchors`` those of the fixed
    anchors too, as the reference."""
    global local_ba_runs
    local_ba_runs += 1
    prob, cam_ids, pt_ids, obs_kf, obs_feat = extract_window_points(
        state, kf_id, max_free=max_free, max_fixed=max_fixed,
        max_points=max_points, scale_factor=scale_factor,
    )
    Tcw_opt, pts_opt, _ = solve_ba_points(
        cam, prob, chi2_mono=chi2_mono, chi2_stereo=chi2_stereo,
        phase_iters=phase_iters, lam=lam,
    )
    K, M = state.kf_capacity, state.mp_capacity
    N = state.kf_mp_idx.shape[1]
    kf_Tcw = set_drop(state.kf_Tcw, torch.where(prob.cam_free & (cam_ids >= 0), cam_ids, K), Tcw_opt)
    mp_pos = set_drop(state.mp_pos, torch.where(prob.pt_valid & (pt_ids >= 0), pt_ids, M), pts_opt)

    chi2 = _chi2_point(cam, prob, Tcw_opt, pts_opt)
    chi2_th_e = torch.where(prob.obs_right_u > 0, chi2_stereo, chi2_mono)
    ci_c = prob.obs_cam.clamp(0, prob.cam_Tcw.shape[0] - 1).long()
    # with ``erase_in_anchors`` in the fixed anchors too, as ORB-SLAM2 erases
    # every outlier edge of the window: an outlier left in an anchor stays
    # among the point's observations, which the solve no longer fits
    remove = prob.obs_valid & (chi2 > 2.0 * chi2_th_e)
    if not erase_in_anchors:
        remove = remove & prob.cam_free[ci_c]

    kf_mp_idx = _set_drop_2d(state.kf_mp_idx, torch.where(remove, obs_kf, K).reshape(-1),
                             obs_feat.clamp(0, N - 1).reshape(-1), -1)
    # reverse index: clear exactly the removed [P, O] entries
    P, O = remove.shape
    row = torch.where(remove, pt_ids.clamp(0, M - 1)[:, None], M)
    col = torch.arange(O, device=row.device)[None, :].expand(P, O)
    mp_obs_kf = _set_drop_2d(state.mp_obs_kf, row.reshape(-1), col.reshape(-1), -1)
    mp_n_obs = torch.clamp(state.mp_n_obs - count_into(row, M), min=0)
    return state._replace(
        kf_Tcw=kf_Tcw, mp_pos=mp_pos, kf_mp_idx=kf_mp_idx,
        mp_obs_kf=mp_obs_kf, mp_n_obs=mp_n_obs,
    )
