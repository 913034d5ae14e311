"""Local-mapping ops: triangulation, the two fuse directions, map-point and
keyframe culling (port of ``orb_slam2_ros2_tpu/mapstate/mapping.py``;
reference src/LocalMapping.cc createNewMapPoints :165-339, fuseMapPoints
:352-405, cullingMapPoints :674-714, cullingKeyFrames :421-614).

Each op is one pass of tensor ops over padded arrays and never synchronises
with the host.  ``kf_id`` is the new keyframe's id, a host int (the
system's ``_n_kf`` mirror) or an int [1] device tensor (a captured keyframe
program's); it and the ids chosen on the device (neighbours, cull
candidates) index through [1]-shaped long tensors (``kf_index``, ``_row``),
since a 0-d tensor index would be read back to the host.  Scatters whose targets can
repeat keep the last writer (``utils.set_drop``), as XLA:CPU does.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..features.frame import FrameFeatures
from ..geometry import se3
from ..geometry import triangulate as tri
from ..geometry.camera import CameraParams, project, unproject
from ..matching.matcher import MatchResult, search_mappoints_projection
from ..ops.hamming import hamming_matrix
from ..utils import add_drop_, mask_from_ids, set_drop, topk_bounded
from .local_map import LocalMap, local_map_snapshot
from .map_state import (
    MapState,
    _append_observations,
    _covis_row_for_kf,
    _distill_descriptors,
    _set_drop_2d,
    _update_normals_and_depth,
    kf_index,
    merge_mappoints,
)

BIG = 1 << 20


def _row(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Row ``k`` ([1] long) of ``x``, gathered on the device."""
    return x.index_select(0, k)[0]


def _set_covis_row(covis: torch.Tensor, k: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """``covis.at[k, :].set(row).at[:, k].set(row)`` for a [1] long ``k``."""
    return covis.index_copy(0, k, row[None]).index_copy(1, k, row[:, None])


def _fundamental_from_poses(cam: CameraParams, Tcw1: torch.Tensor, Tcw2: torch.Tensor) -> torch.Tensor:
    """F21 with x2ᵀ F21 x1 = 0 for pixel homogeneous coords (batched over
    ``Tcw2``'s leading dims).  K⁻¹ is closed-form: ``torch.linalg.inv``
    checks its result on the host."""
    T21 = Tcw2 @ se3.inverse(Tcw1)
    E = se3.hat(se3.t_of(T21)) @ se3.R_of(T21)
    z, o = torch.zeros_like(cam.fx), torch.ones_like(cam.fx)
    Kinv = torch.stack([
        torch.stack([1.0 / cam.fx, z, -cam.cx / cam.fx]),
        torch.stack([z, 1.0 / cam.fy, -cam.cy / cam.fy]),
        torch.stack([z, z, o]),
    ])
    return Kinv.T @ E @ Kinv


def triangulate_new_points(
    state: MapState,
    kf_id,
    cam: CameraParams,
    *,
    n_neighbors: int = 10,
    scale_factor: float = 1.2,
    n_levels: int = 8,
    baseline: float,
    max_dist: int = 50,
    ratio: float = 0.6,
    rank_gate: float = 1e-3,
    chi2_mono: float = 5.991,
    chi2_stereo: float = 7.815,
) -> MapState:
    """Create map points by triangulating the new keyframe's unmatched
    features against its top covisible neighbours, all neighbours in one
    batched ``[J, Nc, Nc]`` epipolar-gated hamming match.  Each feature
    creates at most one point, against the first neighbour (covisibility
    order) that matches it; both sides are compacted to their first ``N/2``
    unmatched features."""
    N = state.kf_uv.shape[1]
    Nc = max(N // 2, 1)
    K, M = state.kf_capacity, state.mp_capacity
    O = state.mp_obs_kf.shape[1]
    J = n_neighbors
    dev = state.kf_Tcw.device
    k = kf_index(kf_id, dev)
    w = _row(state.covis, k) * state.kf_valid.to(torch.int32)
    nb_w, nb_ids = topk_bounded(w, J)

    Tcw1 = _row(state.kf_Tcw, k)
    Twc1 = se3.inverse(Tcw1)
    c1 = se3.t_of(Twc1)
    arangeN = torch.arange(N, dtype=torch.int32, device=dev)
    # compact the new-KF side to its unmatched features [Nc]
    free1_full = _row(state.kf_feat_valid, k) & (_row(state.kf_mp_idx, k) < 0)
    sel_v, ids1 = topk_bounded(torch.where(free1_full, N - arangeN, 0), Nc)
    free1 = sel_v > 0
    uv1 = _row(state.kf_uv, k)[ids1]
    oct1 = _row(state.kf_octave, k)[ids1]
    desc1 = _row(state.kf_desc, k)[ids1]
    depth1 = _row(state.kf_depth, k)[ids1]

    # per-neighbour gathers, compacted to unmatched features [J, Nc, ...]
    Tcw2 = state.kf_Tcw[nb_ids]
    Twc2 = se3.inverse(Tcw2)
    c2 = Twc2[:, :3, 3]
    free2_full = state.kf_feat_valid[nb_ids] & (state.kf_mp_idx[nb_ids] < 0)
    sel2_v, ids2 = topk_bounded(torch.where(free2_full, N - arangeN, 0), Nc)
    free2 = sel2_v > 0
    jn = nb_ids[:, None]
    uv2 = state.kf_uv[jn, ids2]
    oct2 = state.kf_octave[jn, ids2]
    desc2 = state.kf_desc[jn, ids2]
    depth2 = state.kf_depth[jn, ids2]
    base_ok = torch.linalg.vector_norm(c2 - c1[None], dim=1) > baseline
    ok_nb = (nb_w > 0) & (nb_ids != k) & base_ok

    # dense epipolar-gated matching, all neighbours at once
    dist = hamming_matrix(desc1[None], desc2)                           # [J, Nc, Nc]
    F21 = _fundamental_from_poses(cam, Tcw1, Tcw2)
    x1h = torch.cat([uv1, torch.ones_like(uv1[:, :1])], dim=1)
    lines = torch.einsum("na,jba->jnb", x1h, F21)
    x2h = torch.cat([uv2, torch.ones_like(uv2[..., :1])], dim=2)
    num = torch.einsum("jna,jma->jnm", lines, x2h).abs()
    den = torch.sqrt(lines[..., 0] ** 2 + lines[..., 1] ** 2)[..., None]
    d_epi2 = (num / torch.clamp(den, min=1e-9)) ** 2
    sigma2_2 = torch.pow(scale_factor * scale_factor, oct2.float())
    epi_ok = d_epi2 < 3.84 * sigma2_2[:, None, :]

    cand = free1[None, :, None] & free2[:, None, :] & epi_ok & ok_nb[:, None, None]
    masked = torch.where(cand, dist, BIG)
    best = masked.amin(dim=2)
    bj = masked.argmin(dim=2)
    cols = torch.arange(Nc, device=dev)
    second = torch.where(cols[None, None, :] == bj[..., None], BIG, masked).amin(dim=2)
    m_ok = (best <= max_dist) & (best.float() < ratio * second.float())
    # per-column uniqueness within each neighbour: a neighbour feature is
    # claimed by its own best row only, so the neighbour-side slot writes
    # below never collide
    col_best = torch.gather(masked.argmin(dim=1), 1, bj)
    m_ok = m_ok & (col_best == cols[None, :])

    # per-feature neighbour: the first in covisibility order that matched
    any_ok = m_ok.any(dim=0)
    jstar = torch.argmax(m_ok.to(torch.int32), dim=0)
    bj_sel_c = bj[jstar, cols]
    bj_sel = ids2[jstar, bj_sel_c]
    kn_sel = nb_ids[jstar]
    Tcw2_sel = Tcw2[jstar]
    Twc2_sel = Twc2[jstar]
    c2_sel = c2[jstar]
    uv2m = uv2[jstar, bj_sel_c]
    oct2m = oct2[jstar, bj_sel_c]
    depth2m = depth2[jstar, bj_sel_c]

    # parallax choice: triangulate when the two-view parallax beats stereo's
    n1 = torch.stack([(uv1[:, 0] - cam.cx) / cam.fx, (uv1[:, 1] - cam.cy) / cam.fy], dim=1)
    n2 = torch.stack([(uv2m[:, 0] - cam.cx) / cam.fx, (uv2m[:, 1] - cam.cy) / cam.fy], dim=1)
    T1b = Tcw1.expand(Nc, 4, 4)
    cos_par = tri.parallax_cos(T1b, n1, Tcw2_sel, n2)
    half_b = torch.full_like(depth1, baseline / 2.0)
    cos_stereo1 = torch.where(depth1 > 0, torch.cos(2.0 * torch.atan2(half_b, torch.clamp(depth1, min=1e-6))), 2.0)
    cos_stereo2 = torch.where(depth2m > 0, torch.cos(2.0 * torch.atan2(half_b, torch.clamp(depth2m, min=1e-6))), 2.0)
    cos_stereo = torch.minimum(cos_stereo1, cos_stereo2)
    use_tri = (cos_par < cos_stereo) & (cos_par > 0) & (cos_par < 0.9998)

    pw_tri, tri_ok = tri.triangulate_pairs(cam, T1b, uv1, Tcw2_sel, uv2m, rank_gate)
    pw_s1 = se3.apply(Twc1, unproject(cam, uv1, torch.clamp(depth1, min=1e-6)))
    pc2_s = unproject(cam, uv2m, torch.clamp(depth2m, min=1e-6))
    pw_s2 = torch.einsum("nij,nj->ni", Twc2_sel[:, :3, :3], pc2_s) + Twc2_sel[:, :3, 3]
    use_s1 = (~use_tri) & (cos_stereo1 <= cos_stereo2) & (depth1 > 0)
    use_s2 = (~use_tri) & (~use_s1) & (depth2m > 0)
    pw = torch.where(use_tri[:, None], pw_tri, torch.where(use_s1[:, None], pw_s1, pw_s2))
    has_pw = torch.where(use_tri, tri_ok, use_s1 | use_s2)

    # quality gates (checkMapPoint, MapPoint.cc:384-420)
    pc1 = se3.apply(Tcw1, pw)
    pc2 = torch.einsum("nij,nj->ni", Tcw2_sel[:, :3, :3], pw) + Tcw2_sel[:, :3, 3]
    z_ok = (pc1[:, 2] > 0) & (pc2[:, 2] > 0)
    uvp1, _ = project(cam, pc1)
    uvp2, _ = project(cam, pc2)
    s2 = scale_factor * scale_factor
    e1 = torch.sum((uvp1 - uv1) ** 2, dim=1) / torch.pow(s2, oct1.float())
    e2 = torch.sum((uvp2 - uv2m) ** 2, dim=1) / torch.pow(s2, oct2m.float())
    reproj_ok = (e1 < chi2_mono) & (e2 < chi2_mono)
    d1 = torch.linalg.vector_norm(pw - c1, dim=1)
    d2 = torch.linalg.vector_norm(pw - c2_sel, dim=1)
    ratio_dist = d2 / torch.clamp(d1, min=1e-9)
    ratio_octave = torch.pow(scale_factor, (oct2m - oct1).float())
    ratio_factor = 1.5 * scale_factor
    scale_ok = (ratio_dist < ratio_octave * ratio_factor) & (ratio_dist * ratio_factor > ratio_octave)
    create = any_ok & has_pw & z_ok & reproj_ok & scale_ok & (d1 > 1e-6) & (d2 > 1e-6)

    # single allocation pass: contiguous ids from next_mp
    next_mp0 = state.next_mp
    new_ids = torch.where(create, next_mp0 + torch.cumsum(create.to(torch.int32), dim=0) - 1, -1)
    create = create & (new_ids < M)
    new_ids = torch.where(create, new_ids, -1).to(torch.int32)
    tgt = torch.where(create, new_ids, M)
    # fresh points carry exactly two observations, in list slots 0 and 1
    obs_kf_row = torch.stack([torch.where(create, k, -1), torch.where(create, kn_sel, -1)], dim=1)
    obs_feat_row = torch.stack([torch.where(create, ids1, -1), torch.where(create, bj_sel, -1)], dim=1)
    pad = torch.full((Nc, O - 2), -1, dtype=torch.int32, device=dev)
    st = state._replace(
        mp_pos=set_drop(state.mp_pos, tgt, pw),
        mp_desc=set_drop(state.mp_desc, tgt, desc1),
        mp_valid=set_drop(state.mp_valid, tgt, True),
        mp_ref_kf=set_drop(state.mp_ref_kf, tgt, k.expand(Nc)),
        mp_first_kf=set_drop(state.mp_first_kf, tgt, k.expand(Nc)),
        mp_n_obs=set_drop(state.mp_n_obs, tgt, 2),
        mp_visible=set_drop(state.mp_visible, tgt, 1),
        mp_found=set_drop(state.mp_found, tgt, 1),
        mp_obs_kf=set_drop(state.mp_obs_kf, tgt, torch.cat([obs_kf_row.to(torch.int32), pad], dim=1)),
        mp_obs_feat=set_drop(state.mp_obs_feat, tgt, torch.cat([obs_feat_row.to(torch.int32), pad], dim=1)),
        next_mp=torch.clamp(next_mp0 + create.to(torch.int32).sum(), max=M).to(torch.int32),
    )
    row = set_drop(_row(st.kf_mp_idx, k), torch.where(create, ids1, N), new_ids)
    kf_mp_idx = st.kf_mp_idx.index_copy(0, k, row[None])
    # neighbour-side slots (unique per neighbour, see col_best above)
    kf_mp_idx = _set_drop_2d(kf_mp_idx, torch.where(create, kn_sel, K), bj_sel.clamp(0, N - 1), new_ids)
    st = st._replace(kf_mp_idx=kf_mp_idx)

    # descriptors + normals once over every point allocated above
    all_new = next_mp0 + torch.arange(Nc, dtype=torch.int32, device=dev)
    all_new = torch.where(all_new < st.next_mp, all_new, -1)
    st = _distill_descriptors(st, all_new)
    st = _update_normals_and_depth(st, all_new, scale_factor, n_levels)
    return st._replace(covis=_set_covis_row(st.covis, k, _covis_row_for_kf(st, k)))


def cull_mappoints(
    state: MapState,
    current_kf,
    *,
    cull_score: float = 0.25,
    settle_kfs: int = 3,
    window: Optional[int] = None,
) -> MapState:
    """Remove recent map points with found/visible < ``cull_score`` or still
    < 2 observations two keyframes after creation (reference
    cullingMapPoints).  Bump allocation is contiguous, so only the id window
    ``[next_mp − W, next_mp)`` is examined."""
    M = state.mp_capacity
    N = state.kf_mp_idx.shape[1]
    K = state.kf_capacity
    W = min(window if window is not None else 8 * N, M)
    dev = state.mp_pos.device
    start = torch.clamp(state.next_mp - W, 0, M - W)
    ids = start + torch.arange(W, dtype=torch.int32, device=dev)
    il = ids.long()

    found, visible = state.mp_found[il], state.mp_visible[il]
    first_kf, n_obs = state.mp_first_kf[il], state.mp_n_obs[il]
    score = found.float() / torch.clamp(visible.float(), min=1.0)
    current_kf = kf_index(current_kf, dev)
    recent = (first_kf >= 0) & (current_kf <= first_kf + settle_kfs)
    bad_obs = (current_kf >= first_kf + 2) & (n_obs < 2)
    cull = state.mp_valid[il] & recent & ((score < cull_score) | bad_obs)

    # clear the keyframe slots of culled points through their observation lists
    obs_kf, obs_feat = state.mp_obs_kf[il], state.mp_obs_feat[il]
    okc = cull[:, None] & (obs_kf >= 0)
    kf_mp_idx = _set_drop_2d(state.kf_mp_idx, torch.where(okc, obs_kf, K).reshape(-1),
                             obs_feat.clamp(0, N - 1).reshape(-1), -1)
    mp_valid = set_drop(state.mp_valid, torch.where(cull, ids, M), False)
    return state._replace(mp_valid=mp_valid, kf_mp_idx=kf_mp_idx)


def cull_keyframes(
    state: MapState,
    kf_id,
    *,
    n_candidates: int = 10,
    redundancy: float = 0.9,
    min_obs: int = 3,
    n_reparent_iters: int = 6,
) -> MapState:
    """Remove redundant covisible neighbours of the new keyframe (reference
    cullingKeyFrames): a candidate goes when ≥ ``redundancy`` of its points
    are seen by ≥ ``min_obs`` other live keyframes at the same or a finer
    octave.  The observer gathers are one batched ``[J, N, O]`` pass; the
    per-candidate loop re-masks them by live ``kf_valid`` so same-pass culls
    stop counting, then reparents the culled KF's children greedily by
    covisibility (findParent), the leftovers to its parent, and freezes its
    pose relative to its parent in ``kf_Tcp``."""
    K = state.kf_capacity
    N = state.kf_mp_idx.shape[1]
    M = state.mp_capacity
    dev = state.kf_Tcw.device
    k = kf_index(kf_id, dev)
    w = _row(state.covis, k) * state.kf_valid.to(torch.int32)
    wv, cand_ids = topk_bounded(w, n_candidates)

    # batched redundancy check over all candidates [J, N, O]
    mp_b = state.kf_mp_idx[cand_ids]
    has_b = (mp_b >= 0) & state.kf_feat_valid[cand_ids]
    mc_b = mp_b.clamp(0, M - 1).long()
    obs_kf_b = state.mp_obs_kf[mc_b]
    obs_kfc_b = obs_kf_b.clamp(0, K - 1).long()
    ok_b = (obs_kf_b >= 0) & (obs_kf_b != cand_ids[:, None, None]) & has_b[..., None]
    octs_b = state.kf_octave[obs_kfc_b, state.mp_obs_feat[mc_b].clamp(0, N - 1).long()]
    finer_b = ok_b & (octs_b <= state.kf_octave[cand_ids][..., None] + 1)
    n_mp_b = torch.clamp(has_b.to(torch.int32).sum(dim=1), min=1)

    # keyframes carrying a loop edge are never culled
    le = state.loop_edges
    has_loop_edge = mask_from_ids(le.reshape(-1), K)

    C = max(n_reparent_iters, 2)
    st = state
    for j in range(n_candidates):
        kj = cand_ids[j:j + 1]                                          # [1]
        cand_ok = ((wv[j:j + 1] > 0) & (kj != k) & (kj != 0)
                   & st.kf_valid[kj] & ~has_loop_edge[kj])
        has, mc = has_b[j], mc_b[j]
        obs_live = finer_b[j] & st.kf_valid[obs_kfc_b[j]]
        redundant = has & (obs_live.to(torch.int32).sum(dim=1) >= min_obs)
        cull = (cand_ok & (redundant.to(torch.int32).sum() >= redundancy * n_mp_b[j])
                & (n_mp_b[j] > 20))                                     # [1]

        # apply the cull as masked writes (no-ops when cull is False)
        kf_valid = st.kf_valid.index_copy(0, kj, st.kf_valid[kj] & ~cull)
        clear = cull & has[:, None] & (obs_kf_b[j] == kj)
        tgt = torch.where(has & cull, mc, M)
        # a point repeated in the candidate's row writes the same list twice
        mp_obs_kf = set_drop(st.mp_obs_kf, tgt, torch.where(clear, -1, st.mp_obs_kf[mc]))
        mp_n_obs = add_drop_(st.mp_n_obs.clone(), tgt, -clear.to(torch.int32).sum(dim=1))
        kf_mp_idx = st.kf_mp_idx.index_copy(0, kj, torch.where(cull[:, None], -1, st.kf_mp_idx[kj]))
        covis = st.covis.index_copy(0, kj, torch.where(cull[:, None], 0, st.covis[kj]))
        covis = covis.index_copy(1, kj, torch.where(cull[None, :], 0, covis[:, kj]))

        # greedy max-weight reparenting over the top-C children
        parent = st.kf_parent[kj]                                       # [1]
        children = (st.kf_parent == kj) & st.kf_valid & cull
        cw, cids = topk_bounded(children.to(torch.int32), C)
        cvalid = cw > 0
        cand_mask = torch.zeros(K, dtype=torch.bool, device=dev).index_copy(
            0, parent.clamp(0, K - 1).long(), parent >= 0)
        kf_parent = st.kf_parent
        for _ in range(n_reparent_iters):
            Wc = torch.where(cvalid[:, None] & cand_mask[None, :], covis[cids], 0)
            flat = torch.argmax(Wc.reshape(-1)).reshape(1)
            do = cull & (Wc.amax().reshape(1) > 0)
            ci_local = flat // K
            ci = cids[ci_local]
            kf_parent = set_drop(kf_parent, torch.where(do, ci, K), flat % K)
            cvalid = torch.where(do, cvalid.index_fill(0, ci_local, False), cvalid)
            children = torch.where(do, children.index_fill(0, ci, False), children)
            cand_mask = torch.where(do, cand_mask.index_fill(0, ci, True), cand_mask)
        # leftovers fall back to the culled keyframe's parent
        kf_parent = torch.where(children, parent, kf_parent)
        Tcp = st.kf_Tcw[kj] @ se3.inverse(st.kf_Tcw[parent.clamp(0, K - 1).long()])
        Tcp = torch.where((cull & (parent >= 0))[:, None, None], Tcp, st.kf_Tcp[kj])
        st = st._replace(
            kf_valid=kf_valid, mp_obs_kf=mp_obs_kf, mp_n_obs=mp_n_obs,
            kf_mp_idx=kf_mp_idx, covis=covis, kf_parent=kf_parent,
            kf_Tcp=st.kf_Tcp.index_copy(0, kj, Tcp),
        )
    return st


def _kf_features(state: MapState, k: torch.Tensor) -> FrameFeatures:
    """Keyframe ``k`` ([1] long) as a FrameFeatures (projection searches)."""
    N = state.kf_uv.shape[1]
    uv = state.kf_uv[k][0]
    return FrameFeatures(
        uv=uv, uv_raw=uv, octave=state.kf_octave[k][0],
        response=torch.ones(N, dtype=torch.float32, device=uv.device),
        angle=state.kf_angle[k][0], desc=state.kf_desc[k][0],
        valid=state.kf_feat_valid[k][0],
    )


def _apply_fuse_matches(
    state: MapState,
    k: torch.Tensor,
    m: MatchResult,
    cand_mp: torch.Tensor,
    *,
    allow_merge: bool = True,
    loop_priority: bool = False,
) -> MapState:
    """Apply fuse matches into keyframe ``k`` ([1] long): attach candidates
    to empty feature slots, merge with occupants (the better-observed point
    wins, or the candidate under ``loop_priority``).  Candidate validity is
    re-checked live, so a point merged away by an earlier application stays
    out."""
    M = state.mp_capacity
    N = state.kf_mp_idx.shape[1]
    found = m.found & (cand_mp >= 0) & state.mp_valid[cand_mp.clamp(0, M - 1).long()]
    fj = m.idx.clamp(0, N - 1).long()
    cur_mp = state.kf_mp_idx[k][0]
    mp_old = cur_mp[fj]

    # attach to empty slots (mutual_filter makes the targets unique)
    attach = found & (mp_old < 0)
    row = set_drop(cur_mp, torch.where(attach, fj, N), cand_mp)
    st = state._replace(kf_mp_idx=state.kf_mp_idx.index_copy(0, k, row[None]))
    st = _append_observations(st, k, cand_mp, fj, attach)
    if not allow_merge:
        return st
    merge = found & (mp_old >= 0) & (mp_old != cand_mp)
    if loop_priority:
        win_new = torch.ones_like(merge)
    else:
        win_new = st.mp_n_obs[cand_mp.clamp(0, M - 1).long()] >= st.mp_n_obs[mp_old.clamp(0, M - 1).long()]
    winner = torch.where(win_new, cand_mp, mp_old)
    loser = torch.where(win_new, mp_old, cand_mp)
    return merge_mappoints(st, winner, loser, merge)


def fuse_candidates_into_keyframe(
    state: MapState,
    kf_id,
    cam: CameraParams,
    local: LocalMap,
    *,
    width: int,
    height: int,
    scale_factor: float = 1.2,
    n_levels: int = 8,
    th: float = 3.0,
    max_dist: int = 50,
    ratio: float = 0.6,
    loop_priority: bool = False,
    allow_merge: bool = True,
    update_stats: bool = True,
) -> MapState:
    """Fuse a candidate set (a ``LocalMap`` snapshot) into ``kf_id``:
    projection search, then attach / merge; ``update_stats`` refreshes the
    touched points' descriptors and normals and the keyframe's covisibility
    row."""
    N = state.kf_uv.shape[1]
    M = state.mp_capacity
    dev = state.kf_Tcw.device
    k = kf_index(kf_id, dev)
    cur_mp = _row(state.kf_mp_idx, k)
    # the keyframe's own points are not candidates
    own = mask_from_ids(cur_mp, M)
    cand_valid = local.valid & ~own[local.mp_ids.clamp(0, M - 1).long()]
    m = search_mappoints_projection(
        cam, _row(state.kf_Tcw, k),
        local.pos, local.normal, local.min_dist, local.max_dist, local.desc,
        cand_valid, _kf_features(state, k), torch.zeros(N, dtype=torch.bool, device=dev),
        th=th, width=width, height=height, scale_factor=scale_factor,
        n_levels=n_levels, max_dist=max_dist, ratio=ratio, exclude_taken=False,
    )
    st = _apply_fuse_matches(state, k, m, torch.where(cand_valid, local.mp_ids, -1),
                             allow_merge=allow_merge, loop_priority=loop_priority)
    if not update_stats:
        return st
    touched = torch.where(m.found, local.mp_ids, -1)
    st = _distill_descriptors(st, touched)
    st = _update_normals_and_depth(st, touched, scale_factor, n_levels)
    return st._replace(covis=_set_covis_row(st.covis, k, _covis_row_for_kf(st, k)))


def fuse_into_keyframe(
    state: MapState,
    kf_id,
    cam: CameraParams,
    *,
    width: int,
    height: int,
    scale_factor: float = 1.2,
    n_levels: int = 8,
    th: float = 3.0,
    max_dist: int = 50,
    max_fuse: int = 2048,
) -> MapState:
    """Forward fuse: the map points of the new keyframe's 2-ring
    neighbourhood (ring 1 first, at most ``max_fuse``) projected into it
    (reference fuseMapPoints + ORBMatcher::fuse)."""
    local = local_map_snapshot(state, kf_id, n_first=10, n_second=5, max_kfs=32, max_mps=max_fuse)
    return fuse_candidates_into_keyframe(
        state, kf_id, cam, local,
        width=width, height=height, scale_factor=scale_factor,
        n_levels=n_levels, th=th, max_dist=max_dist, ratio=0.6,
    )


def fuse_keyframe_into_neighbors(
    state: MapState,
    kf_id,
    cam: CameraParams,
    *,
    n_neighbors: int = 5,
    width: int,
    height: int,
    scale_factor: float = 1.2,
    n_levels: int = 8,
    th: float = 3.0,
    max_dist: int = 50,
    ratio: float = 0.6,
    allow_merge: bool = True,
) -> MapState:
    """Backward fuse: the new keyframe's points projected into its top
    covisible neighbours.  The searches all read the entry state; the
    attach/merge applications run neighbour by neighbour; descriptors,
    normals and the touched covisibility rows (an order-independent
    symmetric max) are refreshed once at the end."""
    M, K = state.mp_capacity, state.kf_capacity
    N = state.kf_uv.shape[1]
    dev = state.kf_Tcw.device
    k = kf_index(kf_id, dev)
    w = _row(state.covis, k) * state.kf_valid.to(torch.int32)
    nb_w, nb_ids = topk_bounded(w, n_neighbors)

    mp = _row(state.kf_mp_idx, k)
    mpc = mp.clamp(0, M - 1).long()
    base_valid = _row(state.kf_feat_valid, k) & (mp >= 0)
    cand_ids = torch.where(base_valid, mp, -1)
    cand = (state.mp_pos[mpc], state.mp_normal[mpc], state.mp_min_dist[mpc],
            state.mp_max_dist[mpc], state.mp_desc[mpc])
    ok_nb = (nb_w > 0) & (nb_ids != k) & state.kf_valid[nb_ids]
    no_taken = torch.zeros(N, dtype=torch.bool, device=dev)

    matches = []
    for j in range(n_neighbors):
        kn = nb_ids[j:j + 1]
        own = mask_from_ids(state.kf_mp_idx[kn][0], M)
        valid = base_valid & state.mp_valid[mpc] & ok_nb[j] & ~own[mpc]
        m = search_mappoints_projection(
            cam, state.kf_Tcw[kn][0], *cand, valid, _kf_features(state, kn), no_taken,
            th=th, width=width, height=height, scale_factor=scale_factor,
            n_levels=n_levels, max_dist=max_dist, ratio=ratio, exclude_taken=False,
        )
        matches.append(MatchResult(idx=torch.where(ok_nb[j], m.idx, -1), dist=m.dist))

    st = state
    for j, m in enumerate(matches):
        st = _apply_fuse_matches(st, nb_ids[j:j + 1], m, cand_ids, allow_merge=allow_merge)
    touched = torch.where(base_valid & st.mp_valid[mpc], mp, -1)
    st = _distill_descriptors(st, touched)
    st = _update_normals_and_depth(st, touched, scale_factor, n_levels)

    covis = st.covis
    rows = torch.stack([_covis_row_for_kf(st, nb_ids[j:j + 1]) for j in range(n_neighbors)])
    keep = ok_nb & (nb_w > 0)
    rows = torch.where(keep[:, None], rows, covis[nb_ids])
    safe_ids = torch.where(keep, nb_ids, K)
    covis = set_drop(covis, safe_ids, rows)
    covis = set_drop(covis.T, safe_ids, rows).T
    covis = torch.maximum(covis, covis.T)
    return st._replace(covis=_set_covis_row(covis, k, _covis_row_for_kf(st, k)))
