"""Protobuf map interop with the reference (port of
``orb_slam2_ros2_tpu/io/proto_map.py``).

The reference persists its map as an ``orbslam2.MapData`` protobuf
(src/Map.cc:200-319, proto/Keyframe.proto:43-69, proto/MapPoint.proto:15-32)
and relinks pointers after load (``processConnection``, Map.cc:322-381).
Here loading fills the fixed-capacity ``MapState`` directly and the relink is
an array rebuild: keyframe and map-point ids are remapped to dense slots, the
reverse observation index is rebuilt from the per-feature map-point table,
the covisibility matrix from the stored edges and the spanning tree from the
children lists.  A map either package writes is the other's, byte for byte.

Writing reads each needed ``MapState`` field back from the device once, for
the valid rows only, and words every valid keyframe in one ``transform``
call.  Needs ``google.protobuf`` (imported on use).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SLAMConfig
from ..mapstate.map_state import MapState, empty_map

_KF_FIELDS = ("kf_uv", "kf_octave", "kf_angle", "kf_right_u", "kf_depth", "kf_desc",
              "kf_feat_valid", "kf_mp_idx", "kf_Tcw", "covis", "kf_parent")
_MP_FIELDS = ("mp_pos", "mp_normal", "mp_desc", "mp_min_dist", "mp_max_dist", "mp_ref_kf",
              "mp_visible", "mp_found", "mp_obs_kf", "mp_obs_feat")


def _desc_to_u32(data: bytes) -> np.ndarray:
    buf = np.frombuffer(data, np.uint8)
    if buf.size < 32:
        buf = np.pad(buf, (0, 32 - buf.size))
    return buf[:32].view(np.uint32)


def state_to_msg(state: MapState, cfg: SLAMConfig, vocab=None):
    """Build the reference's MapData message from a MapState (Map.cc:200-249).
    Shared by the protobuf and the txt writers: the message carries exactly
    the fields both reference formats persist."""
    from ..proto import MapData

    kf_ids = torch.nonzero(state.kf_valid).flatten()
    mp_ids = torch.nonzero(state.mp_valid).flatten()
    kf = {f: getattr(state, f)[kf_ids].cpu().numpy() for f in _KF_FIELDS}
    mp = {f: getattr(state, f)[mp_ids].cpu().numpy() for f in _MP_FIELDS}
    loops = state.loop_edges.cpu().numpy().tolist()
    words = idf = None
    if vocab is not None:
        from ..bow.vocabulary import transform

        words = transform(vocab, state.kf_desc[kf_ids], state.kf_feat_valid[kf_ids]).cpu().numpy()
        idf = vocab.idf.cpu().numpy()
    kf_ids, mp_ids = kf_ids.cpu().numpy().tolist(), mp_ids.cpu().numpy().tolist()

    msg = MapData()
    msg.keyframes.next_id = int(state.next_kf)
    sf = cfg.orb.scale_factor
    msg.keyframes.scale_factors.extend([sf**i for i in range(cfg.orb.n_levels)])

    children: dict = {}
    for k, p in zip(kf_ids, kf["kf_parent"].tolist()):
        if p >= 0:
            children.setdefault(p, []).append(k)

    for i, k in enumerate(kf_ids):
        out = msg.keyframes.keyframes.add()
        out.id = k
        out.min_u, out.min_v = 0.0, 0.0
        out.max_u, out.max_v = float(cfg.camera.width), float(cfg.camera.height)
        sel = np.nonzero(kf["kf_feat_valid"][i])[0]
        for (x, y), octave, angle in zip(kf["kf_uv"][i, sel].tolist(), kf["kf_octave"][i, sel].tolist(),
                                         kf["kf_angle"][i, sel].tolist()):
            kp = out.keypoints.add()
            kp.x, kp.y = x, y
            kp.octave, kp.angle = octave, angle
        out.right_u.extend(kf["kf_right_u"][i, sel].tolist())
        out.depths.extend(kf["kf_depth"][i, sel].tolist())
        for d in kf["kf_desc"][i, sel]:
            out.descriptors.add().data = d.tobytes()
        out.map_points.extend(kf["kf_mp_idx"][i, sel].tolist())
        T = kf["kf_Tcw"][i]
        out.pose.rotation.extend(T[:3, :3].reshape(-1).tolist())
        out.pose.translation.extend(T[:3, 3].tolist())
        covis = kf["covis"][i]
        for nb in np.nonzero(covis > 0)[0].tolist():
            e = out.connected_kfs.add()
            e.id, e.weight = nb, int(covis[nb])
        out.children_ids.extend(children.get(k, []))
        for a, b in loops:
            if a == k and b >= 0:
                out.loop_edges.append(b)
            elif b == k and a >= 0:
                out.loop_edges.append(a)
        if words is not None:
            w = words[i]
            uniq, counts = np.unique(w[w >= 0], return_counts=True)
            vals = counts * idf[uniq]
            norm = max(float(np.linalg.norm(vals)), 1e-9)
            for u, v in zip(uniq, vals):
                out.bow_vector.words[int(u)] = float(v / norm)
            # the DBoW3 feature vector: this keyframe's saved features grouped
            # by word (leaf node ids; meaningful where both sides load the
            # same vocabulary), for the reference's searchByBow readers
            # (KeyFrame.cc:483-496)
            groups: dict = {}
            for local_j, wid in enumerate(w[sel].tolist()):
                if wid >= 0:
                    groups.setdefault(wid, []).append(local_j)
            for wid in sorted(groups):
                node = out.feature_vector.nodes.add()
                node.node_id = wid
                node.feature_ids.extend(groups[wid])

    # the reference feature of each point: its first observation in its
    # reference keyframe, else 0
    ref = mp["mp_ref_kf"]
    hit = mp["mp_obs_kf"] == ref[:, None]
    first = hit.argmax(1)
    ref_feat = np.where(hit.any(1), mp["mp_obs_feat"][np.arange(len(ref)), first], 0)
    for i, m in enumerate(mp_ids):
        out = msg.mappoints.mappoints.add()
        out.id = m
        out.max_distance = float(mp["mp_max_dist"][i])
        out.min_distance = float(mp["mp_min_dist"][i])
        out.ref_kf_id = max(int(ref[i]), 0)
        out.ref_feat_id = int(ref_feat[i])
        out.matches_in_track = int(mp["mp_found"][i])
        out.inliers_in_track = int(mp["mp_visible"][i])
        out.position.x, out.position.y, out.position.z = mp["mp_pos"][i].tolist()
        out.view_direction.x, out.view_direction.y, out.view_direction.z = mp["mp_normal"][i].tolist()
        out.desc.data = mp["mp_desc"][i].tobytes()
    return msg


def save_proto_map(path: str, state: MapState, cfg: SLAMConfig, vocab=None) -> None:
    """Serialize a MapState as the reference's MapData (Map.cc:200-249)."""
    with open(path, "wb") as f:
        f.write(state_to_msg(state, cfg, vocab).SerializeToString())


def msg_to_state(msg, cfg: SLAMConfig, device) -> MapState:
    """Assemble a MapState on ``device`` from a MapData message
    (Map.cc:252-319 and the relink at :322-381, as array rebuilds).  Shared
    by the protobuf and the txt readers."""
    state = empty_map(cfg, device)
    K, N = cfg.map.max_keyframes, cfg.orb.max_keypoints
    M, O = cfg.map.max_mappoints, cfg.map.max_obs_per_mp

    kfs = list(msg.keyframes.keyframes)
    mps = list(msg.mappoints.mappoints)
    if len(kfs) > K or len(mps) > M:
        raise ValueError(
            f"map exceeds configured capacity: {len(kfs)} KFs (cap {K}), {len(mps)} MPs (cap {M})")
    kfs.sort(key=lambda k: k.id)
    mps.sort(key=lambda m: m.id)
    kf_slot = {k.id: i for i, k in enumerate(kfs)}
    mp_slot = {m.id: i for i, m in enumerate(mps)}

    kf_Tcw = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    kf_uv = np.zeros((K, N, 2), np.float32)
    kf_ru = np.full((K, N), -1.0, np.float32)
    kf_depth = np.full((K, N), -1.0, np.float32)
    kf_oct = np.zeros((K, N), np.int32)
    kf_ang = np.zeros((K, N), np.float32)
    kf_desc = np.zeros((K, N, 8), np.uint32)
    kf_fv = np.zeros((K, N), bool)
    kf_mp = np.full((K, N), -1, np.int32)
    kf_valid = np.zeros((K,), bool)
    kf_frame_id = np.full((K,), -1, np.int32)
    covis = np.zeros((K, K), np.int32)
    parent = np.full((K,), -1, np.int32)
    loop_edges: list = []

    for i, kf in enumerate(kfs):
        kf_valid[i] = True
        kf_frame_id[i] = i
        kps = kf.keypoints[:N]
        n = len(kps)
        if n:
            kf_uv[i, :n] = [(kp.x, kp.y) for kp in kps]
            kf_oct[i, :n] = [kp.octave for kp in kps]
            kf_ang[i, :n] = [kp.angle for kp in kps]
            kf_fv[i, :n] = True
        kf_ru[i, : len(kf.right_u[:N])] = list(kf.right_u[:N])
        kf_depth[i, : len(kf.depths[:N])] = list(kf.depths[:N])
        for j, d in enumerate(kf.descriptors[:N]):
            kf_desc[i, j] = _desc_to_u32(d.data)
        for j, m_id in enumerate(kf.map_points[:N]):
            if m_id >= 0 and m_id in mp_slot:
                kf_mp[i, j] = mp_slot[m_id]
        if len(kf.pose.rotation) == 9 and len(kf.pose.translation) == 3:
            kf_Tcw[i, :3, :3] = np.array(kf.pose.rotation, np.float32).reshape(3, 3)
            kf_Tcw[i, :3, 3] = np.array(kf.pose.translation, np.float32)
        for e in kf.connected_kfs:
            if e.id in kf_slot:
                covis[i, kf_slot[e.id]] = e.weight
        for c in kf.children_ids:
            if c in kf_slot:
                parent[kf_slot[c]] = i
        for le in kf.loop_edges:
            if le in kf_slot:
                a, b = i, kf_slot[le]
                if a < b and (a, b) not in loop_edges:
                    loop_edges.append((a, b))

    covis = np.maximum(covis, covis.T)  # symmetric by construction upstream

    mp_pos = np.zeros((M, 3), np.float32)
    mp_norm = np.zeros((M, 3), np.float32)
    mp_desc = np.zeros((M, 8), np.uint32)
    mp_mind = np.zeros((M,), np.float32)
    mp_maxd = np.full((M,), 1e9, np.float32)
    mp_valid = np.zeros((M,), bool)
    mp_ref = np.full((M,), -1, np.int32)
    mp_vis = np.ones((M,), np.int32)
    mp_fnd = np.ones((M,), np.int32)

    for i, mp in enumerate(mps):
        mp_valid[i] = True
        mp_pos[i] = (mp.position.x, mp.position.y, mp.position.z)
        mp_norm[i] = (mp.view_direction.x, mp.view_direction.y, mp.view_direction.z)
        mp_desc[i] = _desc_to_u32(mp.desc.data)
        mp_mind[i], mp_maxd[i] = mp.min_distance, mp.max_distance
        mp_ref[i] = kf_slot.get(mp.ref_kf_id, -1)
        mp_fnd[i] = mp.matches_in_track
        mp_vis[i] = max(mp.inliers_in_track, 1)

    # the bounded reverse observation index, rebuilt from the feature tables
    # in row-major order (the relink pass, Map.cc:322-381)
    mp_obs_kf = np.full((M, O), -1, np.int32)
    mp_obs_feat = np.full((M, O), -1, np.int32)
    mp_n_obs = np.zeros((M,), np.int32)
    mp_first = np.full((M,), -1, np.int32)
    ks, js = np.nonzero(kf_mp >= 0)
    for k, j in zip(ks.tolist(), js.tolist()):
        m = kf_mp[k, j]
        if mp_first[m] < 0:
            mp_first[m] = k
        o = mp_n_obs[m]
        if o < O:
            mp_obs_kf[m, o] = k
            mp_obs_feat[m, o] = j
            mp_n_obs[m] = o + 1

    edges = np.array(loop_edges + [(-1, -1)] * (64 - len(loop_edges)), np.int32)[:64]

    def t(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(device)

    return state._replace(
        kf_Tcw=t(kf_Tcw), kf_valid=t(kf_valid), kf_frame_id=t(kf_frame_id), kf_uv=t(kf_uv),
        kf_right_u=t(kf_ru), kf_depth=t(kf_depth), kf_octave=t(kf_oct), kf_angle=t(kf_ang),
        kf_desc=t(kf_desc), kf_feat_valid=t(kf_fv), kf_mp_idx=t(kf_mp),
        mp_pos=t(mp_pos), mp_normal=t(mp_norm), mp_desc=t(mp_desc), mp_min_dist=t(mp_mind),
        mp_max_dist=t(mp_maxd), mp_valid=t(mp_valid), mp_ref_kf=t(mp_ref), mp_n_obs=t(mp_n_obs),
        mp_visible=t(mp_vis), mp_found=t(mp_fnd), mp_first_kf=t(mp_first),
        mp_obs_kf=t(mp_obs_kf), mp_obs_feat=t(mp_obs_feat), covis=t(covis), kf_parent=t(parent),
        loop_edges=t(edges),
        next_kf=torch.tensor(len(kfs), dtype=torch.int32, device=device),
        next_mp=torch.tensor(len(mps), dtype=torch.int32, device=device),
    )


def load_proto_map(path: str, cfg: SLAMConfig, device) -> MapState:
    """Parse a reference MapData file into a MapState on ``device``."""
    from ..proto import MapData

    msg = MapData()
    with open(path, "rb") as f:
        msg.ParseFromString(f.read())
    return msg_to_state(msg, cfg, device)
