"""Device-resident SLAM map: fixed-capacity struct-of-arrays of tensors.

Port of ``orb_slam2_ros2_tpu/mapstate/map_state.py`` (the store, its empty
constructor and keyframe insertion).  The observation graph is the table
``kf_mp_idx[K, N]`` plus the bounded reverse index ``mp_obs_kf/mp_obs_feat
[M, O]``; covisibility is a dense ``[K, K]`` count matrix (reference
src/KeyFrame.cc, src/MapPoint.cc, src/Map.cc).  Descriptors are int32 words.

JAX's ``mode="drop"`` scatters become writes through a one-row-longer buffer
(``utils.set_drop``) or clamped adds of zero (``utils.add_drop_``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import SLAMConfig
from ..features.frame import StereoFrame
from ..geometry import se3
from ..geometry.camera import unproject
from ..ops.hamming import hamming_matrix
from ..utils import add_drop_, count_into, set_drop

INT32_MAX = (1 << 31) - 1


class MapState(NamedTuple):
    # --- keyframe store [K] ---
    kf_Tcw: torch.Tensor        # f32[K, 4, 4]
    kf_valid: torch.Tensor      # bool[K]
    kf_frame_id: torch.Tensor   # i32[K] source frame index
    kf_uv: torch.Tensor         # f32[K, N, 2]
    kf_right_u: torch.Tensor    # f32[K, N]
    kf_depth: torch.Tensor      # f32[K, N]
    kf_octave: torch.Tensor     # i32[K, N]
    kf_angle: torch.Tensor      # f32[K, N]
    kf_desc: torch.Tensor       # i32[K, N, 8]
    kf_feat_valid: torch.Tensor  # bool[K, N]
    kf_mp_idx: torch.Tensor     # i32[K, N] map-point id per slot (−1 = none)
    # --- map point store [M] ---
    mp_pos: torch.Tensor        # f32[M, 3]
    mp_normal: torch.Tensor     # f32[M, 3]
    mp_desc: torch.Tensor       # i32[M, 8]
    mp_min_dist: torch.Tensor   # f32[M]
    mp_max_dist: torch.Tensor   # f32[M]
    mp_valid: torch.Tensor      # bool[M]
    mp_ref_kf: torch.Tensor     # i32[M]
    mp_n_obs: torch.Tensor      # i32[M]
    mp_visible: torch.Tensor    # i32[M] tracking "visible" counter
    mp_found: torch.Tensor      # i32[M] tracking "found" counter
    mp_first_kf: torch.Tensor   # i32[M]
    mp_obs_kf: torch.Tensor     # i32[M, O] (−1 = empty)
    mp_obs_feat: torch.Tensor   # i32[M, O]
    # --- graph ---
    covis: torch.Tensor         # i32[K, K]
    kf_parent: torch.Tensor     # i32[K] spanning-tree parent (−1 = root)
    kf_Tcp: torch.Tensor        # f32[K, 4, 4]
    loop_edges: torch.Tensor    # i32[E, 2]
    # --- allocation ---
    next_kf: torch.Tensor       # i32[] bump pointer
    next_mp: torch.Tensor       # i32[]

    @property
    def kf_capacity(self) -> int:
        return self.kf_Tcw.shape[0]

    @property
    def mp_capacity(self) -> int:
        return self.mp_pos.shape[0]


def empty_map(cfg: SLAMConfig, device) -> MapState:
    K = cfg.map.max_keyframes
    N = cfg.orb.max_keypoints
    M = cfg.map.max_mappoints
    O = cfg.map.max_obs_per_mp
    E = 64
    f32, i32 = torch.float32, torch.int32

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=device)

    eye = torch.eye(4, dtype=f32, device=device)
    return MapState(
        kf_Tcw=eye.expand(K, 4, 4).clone(),
        kf_valid=full((K,), False, torch.bool),
        kf_frame_id=full((K,), -1, i32),
        kf_uv=full((K, N, 2), 0.0, f32),
        kf_right_u=full((K, N), -1.0, f32),
        kf_depth=full((K, N), -1.0, f32),
        kf_octave=full((K, N), 0, i32),
        kf_angle=full((K, N), 0.0, f32),
        kf_desc=full((K, N, 8), 0, i32),
        kf_feat_valid=full((K, N), False, torch.bool),
        kf_mp_idx=full((K, N), -1, i32),
        mp_pos=full((M, 3), 0.0, f32),
        mp_normal=full((M, 3), 0.0, f32),
        mp_desc=full((M, 8), 0, i32),
        mp_min_dist=full((M,), 0.0, f32),
        mp_max_dist=full((M,), 1e9, f32),
        mp_valid=full((M,), False, torch.bool),
        mp_ref_kf=full((M,), -1, i32),
        mp_n_obs=full((M,), 0, i32),
        mp_visible=full((M,), 1, i32),
        mp_found=full((M,), 1, i32),
        mp_first_kf=full((M,), -1, i32),
        mp_obs_kf=full((M, O), -1, i32),
        mp_obs_feat=full((M, O), -1, i32),
        covis=full((K, K), 0, i32),
        kf_parent=full((K,), -1, i32),
        kf_Tcp=eye.expand(K, 4, 4).clone(),
        loop_edges=full((E, 2), -1, i32),
        next_kf=full((), 0, i32),
        next_mp=full((), 0, i32),
    )


def grow_map(state: MapState, *, kf_capacity: Optional[int] = None,
             mp_capacity: Optional[int] = None) -> MapState:
    """Copy of ``state`` with enlarged capacities (map-length scaling): the
    stores are re-padded with ``empty_map``'s fill values; slot ids stay
    put.  Capacities never shrink."""
    K0, M0 = state.kf_capacity, state.mp_capacity
    K = kf_capacity if kf_capacity is not None else K0
    M = mp_capacity if mp_capacity is not None else M0
    if K < K0 or M < M0:
        raise ValueError(f"capacities cannot shrink: {(K0, M0)} -> {(K, M)}")
    dK, dM = K - K0, M - M0
    if dK == 0 and dM == 0:
        return state

    def pad(a, n, fill, dim=0):
        if n == 0:
            return a
        shape = list(a.shape)
        shape[dim] = n
        return torch.cat([a, torch.full(shape, fill, dtype=a.dtype, device=a.device)], dim=dim)

    def pad_eye(a):
        eye = torch.eye(4, dtype=a.dtype, device=a.device).expand(dK, 4, 4)
        return torch.cat([a, eye]) if dK else a

    return state._replace(
        kf_Tcw=pad_eye(state.kf_Tcw),
        kf_valid=pad(state.kf_valid, dK, False),
        kf_frame_id=pad(state.kf_frame_id, dK, -1),
        kf_uv=pad(state.kf_uv, dK, 0.0),
        kf_right_u=pad(state.kf_right_u, dK, -1.0),
        kf_depth=pad(state.kf_depth, dK, -1.0),
        kf_octave=pad(state.kf_octave, dK, 0),
        kf_angle=pad(state.kf_angle, dK, 0.0),
        kf_desc=pad(state.kf_desc, dK, 0),
        kf_feat_valid=pad(state.kf_feat_valid, dK, False),
        kf_mp_idx=pad(state.kf_mp_idx, dK, -1),
        mp_pos=pad(state.mp_pos, dM, 0.0),
        mp_normal=pad(state.mp_normal, dM, 0.0),
        mp_desc=pad(state.mp_desc, dM, 0),
        mp_min_dist=pad(state.mp_min_dist, dM, 0.0),
        mp_max_dist=pad(state.mp_max_dist, dM, 1e9),
        mp_valid=pad(state.mp_valid, dM, False),
        mp_ref_kf=pad(state.mp_ref_kf, dM, -1),
        mp_n_obs=pad(state.mp_n_obs, dM, 0),
        mp_visible=pad(state.mp_visible, dM, 1),
        mp_found=pad(state.mp_found, dM, 1),
        mp_first_kf=pad(state.mp_first_kf, dM, -1),
        mp_obs_kf=pad(state.mp_obs_kf, dM, -1),
        mp_obs_feat=pad(state.mp_obs_feat, dM, -1),
        covis=pad(pad(state.covis, dK, 0, dim=0), dK, 0, dim=1),
        kf_parent=pad(state.kf_parent, dK, -1),
        kf_Tcp=pad_eye(state.kf_Tcp),
    )


def copy_into(storage: MapState, new: MapState) -> int:
    """Write the fields of ``new`` that are not ``storage``'s own tensors into
    ``storage``, in place (a field that shares ``storage``'s memory is cloned
    first), and return the bytes written.  How a map that outlasts its
    programs takes a program's result: a captured graph reads the storage at
    fixed addresses."""
    dst, src = [], []
    for a, b in zip(storage, new):
        if a is b or (a.data_ptr() == b.data_ptr() and a.stride() == b.stride()):
            continue
        dst.append(a)
        src.append(b.clone() if a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr() else b)
    if dst:
        torch._foreach_copy_(dst, src)
    return sum(t.numel() * t.element_size() for t in dst)


# --------------------------------------------------------------------------
# observation bookkeeping helpers
# --------------------------------------------------------------------------

def kf_index(kf_id, device) -> torch.Tensor:
    """A keyframe id (host int or 0-d tensor) as a [1] long tensor: indexing
    with it gathers on the device, where a 0-d tensor index would be read
    back to the host.  A host int is filled in by a kernel (``torch.tensor``
    would copy it from the host)."""
    if torch.is_tensor(kf_id):
        return kf_id.reshape(1).long()
    return torch.full((1,), int(kf_id), dtype=torch.long, device=device)

def _set_drop_2d(x: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor, val) -> torch.Tensor:
    """``x.at[rows, cols].set(val, mode="drop")`` for a 2-D ``x`` (rows out of
    range are dropped; ``cols`` must be in range)."""
    R, C = x.shape
    lin = torch.where((rows >= 0) & (rows < R), rows.long() * C + cols.long(), R * C)
    return set_drop(x.reshape(-1), lin, val).reshape(R, C)


def _append_observations(state: MapState, kf_id, mp_ids: torch.Tensor, feat_ids: torch.Tensor,
                         mask: torch.Tensor) -> MapState:
    """Append (kf_id, feat) to each map point's bounded observation list;
    entries past the capacity O are dropped (never overwrite the last)."""
    O = state.mp_obs_kf.shape[1]
    M = state.mp_capacity
    raw_slot = state.mp_n_obs[mp_ids.clamp(0, M - 1).long()]
    ok = mask & (raw_slot < O)
    m = torch.where(ok, mp_ids, M)
    slot = raw_slot.clamp(0, O - 1)
    obs_kf = _set_drop_2d(state.mp_obs_kf, m, slot, torch.where(ok, kf_id, -1).to(torch.int32))
    obs_feat = _set_drop_2d(state.mp_obs_feat, m, slot, torch.where(ok, feat_ids, -1).to(torch.int32))
    n_obs = add_drop_(state.mp_n_obs.clone(), m, ok.to(torch.int32))
    return state._replace(mp_obs_kf=obs_kf, mp_obs_feat=obs_feat, mp_n_obs=n_obs)


def merge_mappoints(state: MapState, winner: torch.Tensor, loser: torch.Tensor,
                    mask: torch.Tensor) -> MapState:
    """Batched MapPoint::replace (reference MapPoint.cc:213-233): the loser's
    keyframe slots are repointed to the winner (slots in keyframes the
    winner already observes are cleared), its observations are appended to
    the winner's bounded list, the winner inherits its tracking counters and
    the loser is invalidated.  ``winner/loser/mask [B]``; rows with
    winner == loser or mask False are no-ops.  A loser named by several rows
    merges once, into its first row's winner; duplicate winners' list writes
    keep the last row (``set_drop``)."""
    K, M = state.kf_capacity, state.mp_capacity
    N = state.kf_uv.shape[1]
    O = state.mp_obs_kf.shape[1]
    dev = winner.device
    live = mask & (winner != loser) & (winner >= 0) & (loser >= 0)
    B = winner.shape[0]
    row_ids = torch.arange(B, dtype=torch.int32, device=dev)
    first_row = torch.full((M + 1,), B, dtype=torch.int32, device=dev).scatter_reduce(
        0, torch.where(live, loser, M).long(), row_ids, reduce="amin")
    live = live & (first_row[loser.clamp(0, M - 1).long()] == row_ids)
    lid = torch.where(live, loser, M)
    lcl = lid.clamp(0, M - 1).long()
    wcl = torch.where(live, winner, M).clamp(0, M - 1).long()
    lo_kf = torch.where(live[:, None], state.mp_obs_kf[lcl], -1)    # [B, O]
    lo_feat = state.mp_obs_feat[lcl]
    wo_kf = state.mp_obs_kf[wcl]

    # does the winner already observe this keyframe?
    dup = torch.any((lo_kf[:, :, None] == wo_kf[:, None, :]) & (wo_kf[:, None, :] >= 0), dim=-1)
    valid_o = lo_kf >= 0
    transfer = valid_o & ~dup

    winner_b = winner[:, None].expand(B, O)
    kf_mp_idx = _set_drop_2d(
        state.kf_mp_idx, torch.where(valid_o, lo_kf, K).reshape(-1),
        lo_feat.clamp(0, N - 1).reshape(-1),
        torch.where(transfer, winner_b, -1).reshape(-1))

    # append the transferred observations to the winner's list
    n_w = state.mp_n_obs[wcl]
    slot = n_w[:, None] + torch.cumsum(transfer.to(torch.int32), dim=1) - 1
    keep = transfer & (slot < O)
    w_idx = torch.where(keep, winner_b, M).reshape(-1)
    s_idx = slot.clamp(0, O - 1).reshape(-1)
    mp_obs_kf = _set_drop_2d(state.mp_obs_kf, w_idx, s_idx, torch.where(keep, lo_kf, -1).reshape(-1))
    mp_obs_feat = _set_drop_2d(state.mp_obs_feat, w_idx, s_idx, torch.where(keep, lo_feat, -1).reshape(-1))
    wid = torch.where(live, winner, M)
    mp_n_obs = add_drop_(state.mp_n_obs.clone(), wid, keep.sum(dim=1))

    # clear + invalidate the loser, move its counters to the winner
    mp_obs_kf = set_drop(mp_obs_kf, lid, -1)
    mp_obs_feat = set_drop(mp_obs_feat, lid, -1)
    mp_n_obs = set_drop(mp_n_obs, lid, 0)
    mp_valid = set_drop(state.mp_valid, lid, False)
    mp_visible = add_drop_(state.mp_visible.clone(), wid, state.mp_visible[lcl])
    mp_found = add_drop_(state.mp_found.clone(), wid, state.mp_found[lcl])
    return state._replace(
        kf_mp_idx=kf_mp_idx, mp_valid=mp_valid,
        mp_obs_kf=mp_obs_kf, mp_obs_feat=mp_obs_feat, mp_n_obs=mp_n_obs,
        mp_visible=mp_visible, mp_found=mp_found,
    )


def _distill_descriptors(state: MapState, mp_ids: torch.Tensor) -> MapState:
    """Representative descriptor per map point: the observation descriptor
    with minimal median hamming distance to the others (reference
    MapPoint::updateDescriptor, MapPoint.cc:336-369).  ``mp_ids [B]`` may
    hold −1 (ignored)."""
    O = state.mp_obs_kf.shape[1]
    ids = mp_ids.clamp(0, state.mp_capacity - 1).long()
    obs_kf = state.mp_obs_kf[ids]      # [B, O]
    obs_feat = state.mp_obs_feat[ids]  # [B, O]
    ok = obs_kf >= 0
    descs = state.kf_desc[obs_kf.clamp(0, state.kf_capacity - 1).long(),
                          obs_feat.clamp(0, state.kf_desc.shape[1] - 1).long()]  # [B, O, 8]

    D = hamming_matrix(descs, descs)  # [B, O, O]
    n = torch.clamp(ok.sum(dim=1), min=1)  # [B]
    # median over valid columns: invalid columns sort to the front as −1
    Ds = torch.sort(torch.where(ok[:, None, :], D, -1), dim=2).values
    med_idx = ((O - n) + n // 2).clamp(0, O - 1)
    med = torch.gather(Ds, 2, med_idx[:, None, None].expand(-1, O, 1).long())[..., 0]  # [B, O]
    med = torch.where(ok, med, INT32_MAX)
    best = torch.argmin(med, dim=1)
    new_desc = torch.gather(descs, 1, best[:, None, None].expand(-1, 1, 8))[:, 0]

    valid = (mp_ids >= 0) & (ok.sum(dim=1) > 0)
    mp_desc = set_drop(state.mp_desc, torch.where(valid, mp_ids, state.mp_capacity), new_desc)
    return state._replace(mp_desc=mp_desc)


def _update_normals_and_depth(state: MapState, mp_ids: torch.Tensor, scale_factor: float,
                              n_levels: int) -> MapState:
    """Mean viewing direction + scale-invariance distance range from the
    first observation's octave (reference MapPoint::updateNormalAndDepth,
    MapPoint.cc:71-90, 429-484)."""
    K = state.kf_capacity
    ids = mp_ids.clamp(0, state.mp_capacity - 1).long()
    obs_kf = state.mp_obs_kf[ids]  # [B, O]
    ok = obs_kf >= 0
    Tk = state.kf_Tcw[obs_kf.clamp(0, K - 1).long()]
    R, t = Tk[..., :3, :3], Tk[..., :3, 3]
    Twc_t = -torch.einsum("...ji,...j->...i", R, t)  # [B, O, 3] camera centres
    pos = state.mp_pos[ids][:, None, :]
    rays = pos - Twc_t
    norms = torch.linalg.vector_norm(rays, dim=-1)
    rays_u = rays / torch.clamp(norms, min=1e-9)[..., None]
    mean_dir = torch.sum(torch.where(ok[..., None], rays_u, 0.0), dim=1)
    mean_dir = mean_dir / torch.clamp(torch.linalg.vector_norm(mean_dir, dim=-1, keepdim=True), min=1e-9)

    feat0 = state.mp_obs_feat[ids][:, 0].clamp(0, state.kf_octave.shape[1] - 1).long()
    kf0 = state.mp_obs_kf[ids][:, 0].clamp(0, K - 1).long()
    octave0 = state.kf_octave[kf0, feat0]
    Tcw0 = state.kf_Tcw[kf0]
    centre0 = -torch.einsum("bij,bj->bi", Tcw0[:, :3, :3].transpose(-1, -2), Tcw0[:, :3, 3])
    dist0 = torch.linalg.vector_norm(state.mp_pos[ids] - centre0, dim=-1)
    max_dist = dist0 * torch.pow(scale_factor, octave0.float())
    min_dist = max_dist / (scale_factor ** (n_levels - 1))

    tgt = torch.where(mp_ids >= 0, mp_ids, state.mp_capacity)
    return state._replace(
        mp_normal=set_drop(state.mp_normal, tgt, mean_dir),
        mp_max_dist=set_drop(state.mp_max_dist, tgt, max_dist),
        mp_min_dist=set_drop(state.mp_min_dist, tgt, min_dist),
    )


def _covis_row_for_kf(state: MapState, kf_id: torch.Tensor) -> torch.Tensor:
    """Shared-map-point counts between keyframe ``kf_id`` ([1] long) and
    every other KF, from the reverse observation index of its map points
    (reference KeyFrame::updateConnections, KeyFrame.cc:54-112)."""
    K = state.kf_capacity
    mp = state.kf_mp_idx.index_select(0, kf_id)[0]   # [N]
    obs = state.mp_obs_kf[mp.clamp(0, state.mp_capacity - 1).long()]  # [N, O]
    ok = (mp >= 0)[:, None] & (obs >= 0) & (obs != kf_id.to(obs.dtype))
    return count_into(torch.where(ok, obs, K), K)


# --------------------------------------------------------------------------
# keyframe insertion
# --------------------------------------------------------------------------

def insert_keyframe(
    state: MapState,
    frame: StereoFrame,
    Tcw: torch.Tensor,
    tracked_mp: torch.Tensor,
    frame_id,
    cam,
    *,
    depth_threshold: float,
    scale_factor: float,
    n_levels: int,
    min_covis_weight: int = 15,
    seed_floor: int = 100,
) -> Tuple[MapState, torch.Tensor]:
    """Insert a keyframe (out of place); ``frame_id`` is a host int or an int
    [1] device tensor.  Mirrors Tracking::insertKeyFrame +
    LocalMapping::processNewKeyFrame (reference Tracking.cc:167-185,
    LocalMapping.cc:121-148): copy the feature table, attach tracked map
    points, seed new map points from close stereo depth (topped up with the
    nearest far ones to ``seed_floor``), refresh descriptors / normals /
    distance ranges, update the covisibility row and the parent.

    Returns (new_state, kf_id) with kf_id a 0-d int32 tensor.
    """
    k = state.next_kf.reshape(1).long()
    N = frame.feats.capacity
    M = state.mp_capacity
    dev = Tcw.device
    f = frame.feats

    def put(x, row):
        return x.index_copy(0, k, row[None].to(x.dtype))

    st = state._replace(
        kf_Tcw=put(state.kf_Tcw, Tcw),
        kf_valid=state.kf_valid.index_fill(0, k, True),
        kf_frame_id=state.kf_frame_id.index_copy(0, k, kf_index(frame_id, dev).to(torch.int32)),
        kf_uv=put(state.kf_uv, f.uv),
        kf_right_u=put(state.kf_right_u, frame.right_u),
        kf_depth=put(state.kf_depth, frame.depth),
        kf_octave=put(state.kf_octave, f.octave),
        kf_angle=put(state.kf_angle, f.angle),
        kf_desc=put(state.kf_desc, f.desc),
        kf_feat_valid=put(state.kf_feat_valid, f.valid),
        next_kf=state.next_kf + 1,
    )

    # -- attach tracked map points -----------------------------------------
    feat_ids = torch.arange(N, dtype=torch.int32, device=dev)
    tracked_ok = (tracked_mp >= 0) & f.valid & st.mp_valid[tracked_mp.clamp(0, M - 1).long()]
    st = st._replace(kf_mp_idx=put(st.kf_mp_idx, torch.where(tracked_ok, tracked_mp, -1)))
    st = _append_observations(st, k, tracked_mp, feat_ids, tracked_ok)

    # -- create new map points from stereo depth ----------------------------
    seedable = f.valid & (frame.depth > 0) & (~tracked_ok)
    is_close = seedable & (frame.depth < depth_threshold)
    n_close = is_close.to(torch.int32).sum()
    need_far = torch.clamp(seed_floor - n_close, min=0)
    far_depth = torch.where(seedable & ~is_close, frame.depth, float("inf"))
    far_rank = torch.argsort(torch.argsort(far_depth, stable=True), stable=True)  # rank by nearness
    close = is_close | (torch.isfinite(far_depth) & (far_rank < need_far))
    n_new = torch.cumsum(close.to(torch.int32), dim=0) - 1
    new_ids = torch.where(close, state.next_mp + n_new, -1)
    close = close & (new_ids < M)
    new_ids = torch.where(close, new_ids, -1).to(torch.int32)

    depth = torch.where(close, frame.depth, 1.0)
    pc = unproject(cam, f.uv, depth)
    Twc = se3.inverse(Tcw)
    pw = se3.apply(Twc, pc)
    normal0 = pw - se3.t_of(Twc)
    normal0 = normal0 / torch.clamp(torch.linalg.vector_norm(normal0, dim=-1, keepdim=True), min=1e-9)

    tgt = torch.where(close, new_ids, M)
    kk = k.to(torch.int32).expand(N)
    st = st._replace(
        mp_pos=set_drop(st.mp_pos, tgt, pw),
        mp_normal=set_drop(st.mp_normal, tgt, normal0),
        mp_valid=set_drop(st.mp_valid, tgt, True),
        mp_ref_kf=set_drop(st.mp_ref_kf, tgt, kk),
        mp_first_kf=set_drop(st.mp_first_kf, tgt, kk),
        mp_desc=set_drop(st.mp_desc, tgt, f.desc),
        mp_n_obs=set_drop(st.mp_n_obs, tgt, 0),
        mp_visible=set_drop(st.mp_visible, tgt, 1),
        mp_found=set_drop(st.mp_found, tgt, 1),
        mp_obs_kf=set_drop(st.mp_obs_kf, tgt, -1),
        mp_obs_feat=set_drop(st.mp_obs_feat, tgt, -1),
        next_mp=torch.clamp(state.next_mp + close.to(torch.int32).sum(), max=M).to(torch.int32),
    )
    row_k = st.kf_mp_idx.index_select(0, k)[0]
    st = st._replace(kf_mp_idx=put(st.kf_mp_idx, torch.where(close, new_ids, row_k)))
    st = _append_observations(st, k, new_ids, feat_ids, close)

    touched = torch.where(close, new_ids, torch.where(tracked_ok, tracked_mp, -1))
    st = _distill_descriptors(st, touched)
    st = _update_normals_and_depth(st, touched, scale_factor, n_levels)

    # -- covisibility + spanning tree -----------------------------------------
    row = _covis_row_for_kf(st, k)
    covis = st.covis.index_copy(0, k, row[None]).index_copy(1, k, row[:, None])
    parent = torch.argmax(row)
    parent_ok = (row.max() >= min_covis_weight) & (state.next_kf > 0)
    st = st._replace(
        covis=covis,
        kf_parent=put(st.kf_parent, torch.where(parent_ok, parent, -1)),
    )
    return st, state.next_kf.clone()
