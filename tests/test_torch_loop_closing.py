"""Parity of the port's loop closer (``pipeline/loop_closing.py``) with the
JAX package's, on the CPU, on a revisit world built here in numpy.

The world (``loop_world``): keyframe 0 sees a cluster of 120 points; chain
keyframes 1..n-1 step 2 m sideways, each seeing its own cluster and the
previous one's; the revisit keyframe n sees keyframe 0's points again
through its OWN duplicate map points, triangulated at a drifted pose (the
loop situation before fusion), plus a far cluster shared with keyframe n-1.
Every observation is the exact stereo projection of its map point through
its keyframe's estimated pose.  ``share=True`` gives the revisit keyframe
keyframe 0's points themselves, ``scramble=True`` permutes its duplicates'
positions (descriptor overlap without consistent geometry).

Integer outputs — match tables, gate counts, ok flags, ids, loop and
essential edge lists, candidate rows, chains — are equal; Sim3s within
1e-4, poses within 1e-4 m / 1e-3°, points within 1e-3 m (5e-3 m after the
essential graph).  Minimal RANSAC sets are drawn with JAX and passed in as
``sets``.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_epnp import jax_minimal_sets
from test_torch_mapping import rot_deg, two_torch_threads  # noqa: F401  (autouse)

import orb_slam2_ros2_tpu.config as jcfg
import orb_slam2_ros2_tpu_torch.config as tcfg
from orb_slam2_ros2_tpu.bow import vocabulary as jvoc
from orb_slam2_ros2_tpu.geometry import sim3 as jsim3
from orb_slam2_ros2_tpu.geometry.camera import CameraParams as JCam
from orb_slam2_ros2_tpu.mapstate import map_state as jms
from orb_slam2_ros2_tpu.pipeline import loop_closing as jlc
from orb_slam2_ros2_tpu.solvers.pose_graph import optimize_pose_graph as j_opg
from orb_slam2_ros2_tpu_torch import convert
from orb_slam2_ros2_tpu_torch.bow import vocabulary as tvoc
from orb_slam2_ros2_tpu_torch.geometry import sim3 as tsim3
from orb_slam2_ros2_tpu_torch.geometry.camera import CameraParams as TCam
from orb_slam2_ros2_tpu_torch.pipeline import loop_closing as tlc
from orb_slam2_ros2_tpu_torch.solvers.pose_graph import optimize_pose_graph as t_opg

W, H, FX, CX, CY, BASELINE = 320, 192, 200.0, 160.0, 96.0, 0.5
GEOM = dict(width=W, height=H, scale_factor=1.2, n_levels=8)
SIM3_TOL, POSE_M, POSE_DEG, POINT_M = 1e-4, 1e-4, 1e-3, 1e-3
INT_TABLES = ("kf_mp_idx", "mp_obs_kf", "mp_obs_feat", "mp_n_obs", "kf_valid", "kf_parent", "covis",
              "mp_valid", "loop_edges", "mp_desc")


def make_cfg(mod, K=8, M=1024, **loop):
    cfg = mod.SLAMConfig(
        camera=mod.CameraConfig(fx=FX, fy=FX, cx=CX, cy=CY, baseline=BASELINE, width=W, height=H),
        orb=mod.ORBConfig(n_features=200, max_keypoints=256),
        map=mod.MapConfig(max_keyframes=K, max_mappoints=M, max_obs_per_mp=8),
        bow=mod.BoWConfig(branching=8, depth=3),
        ba=mod.BAConfig(pcg_iters=20),
    )
    return cfg.replace(loop=mod.LoopConfig(**loop)) if loop else cfg


def pose(rz, tx, tz, ty=0.0):
    """Tcw: rotation rz about the optical axis, then translation."""
    c, s = np.cos(rz), np.sin(rz)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    T[:3, 3] = [tx, ty, tz]
    return T


def project(T, pw):
    pc = pw @ T[:3, :3].T + T[:3, 3]
    return np.stack([FX * pc[:, 0] / pc[:, 2] + CX, FX * pc[:, 1] / pc[:, 2] + CY], 1), pc


def in_image(uv, margin=5):
    return (uv[:, 0] > margin) & (uv[:, 0] < W - margin) & (uv[:, 1] > margin) & (uv[:, 1] < H - margin)


def loop_world(cfg, n_chain=1, P=120, share=False, scramble=False, drift=True, seed=0):
    """The revisit world as a dict of the JAX ``MapState`` fields (numpy),
    and the revisit keyframe's true Tcw."""
    r = np.random.default_rng(seed)
    st = {k: np.array(v) for k, v in jms.empty_map(cfg)._asdict().items()}
    N = cfg.orb.max_keypoints
    bf = FX * BASELINE

    def cluster(Tcw, n, lo=(-4, -2.5, 6), hi=(4, 2.5, 14)):
        pc = r.uniform(lo, hi, (n, 3))
        Twc = np.linalg.inv(Tcw.astype(np.float64))
        return (pc @ Twc[:3, :3].T + Twc[:3, 3]).astype(np.float32)

    chain = [pose(0.0, -2.0 * k, 0.0) for k in range(n_chain)]
    T_true = pose(0.12, 0.6, -0.4)
    T_rev = pose(0.12 + 0.02 * drift, 0.6 + 0.15 * drift, -0.4 + 0.1 * drift)
    if share:
        T_rev = T_true
    poses = chain + [T_rev]

    pos, desc = [], []                   # map points
    obs = [[] for _ in poses]            # per keyframe: (mp id, uv)

    def add_points(p):
        start = len(pos)
        pos.extend(p)
        desc.extend(r.integers(0, 2 ** 32, (len(p), 8), dtype=np.uint32))
        return np.arange(start, start + len(p))

    def observe(k, ids, uv_of=None):
        uv, pc = project(poses[k], np.asarray(pos)[ids]) if uv_of is None else uv_of
        for i, (u, z) in enumerate(zip(uv, pc[:, 2])):
            if in_image(u[None])[0] and z > 0:
                obs[k].append((int(ids[i]), u, z))

    clusters = [add_points(cluster(T, P)) for T in chain]
    for k in range(n_chain):
        observe(k, clusters[k])
        if k:
            observe(k, clusters[k - 1])
    rev = n_chain
    # the revisit: keyframe 0's points seen again at the true pose
    c0 = clusters[0]
    uv_t, pc_t = project(T_true, np.asarray(pos)[c0])
    seen = in_image(uv_t) & (pc_t[:, 2] > 0)
    c0, uv_t, pc_t = c0[seen], uv_t[seen], pc_t[seen]
    if share:
        for i, u, z in zip(c0, uv_t, pc_t[:, 2]):
            obs[rev].append((int(i), u, z))
    else:
        # duplicates triangulated at the drifted pose: T_rev · p' = T_true · p
        Tinv = np.linalg.inv(T_rev.astype(np.float64))
        dup = (pc_t @ Tinv[:3, :3].T + Tinv[:3, 3]).astype(np.float32)
        if scramble:
            dup = dup[r.permutation(len(dup))]
        ids = add_points(dup)
        for j, i in enumerate(ids):
            desc[i] = desc[c0[j]]
            obs[rev].append((int(i), uv_t[j], pc_t[j, 2]))
    if n_chain > 1:
        # a far cluster shared by the revisit keyframe and the last chain one
        mid = 0.5 * (2.0 * (n_chain - 1) - 0.6)
        q = r.uniform((mid - 2.5, -1.5, 36), (mid + 2.5, 1.5, 44), (30, 3)).astype(np.float32)
        qid = add_points(q)
        observe(n_chain - 1, qid)
        observe(rev, qid)

    M_used = len(pos)
    pos, desc = np.asarray(pos, np.float32), np.asarray(desc, np.uint32)
    O = st["mp_obs_kf"].shape[1]
    first = np.full(M_used, -1)
    for k, lst in enumerate(obs):
        assert len(lst) <= N
        st["kf_Tcw"][k] = poses[k]
        st["kf_valid"][k] = True
        st["kf_frame_id"][k] = k
        st["kf_feat_valid"][k, :len(lst)] = True
        st["kf_octave"][k] = 0
        for f, (i, u, z) in enumerate(lst):
            st["kf_uv"][k, f] = u
            st["kf_right_u"][k, f] = u[0] - bf / z
            st["kf_depth"][k, f] = z
            st["kf_desc"][k, f] = desc[i]
            st["kf_mp_idx"][k, f] = i
            n = st["mp_n_obs"][i]
            st["mp_obs_kf"][i, n], st["mp_obs_feat"][i, n] = k, f
            st["mp_n_obs"][i] = n + 1
            if first[i] < 0:
                first[i] = k
        st["kf_parent"][k] = k - 1 if k else -1
    assert st["mp_n_obs"].max() <= O
    centres = np.stack([np.linalg.inv(T.astype(np.float64))[:3, 3] for T in poses]).astype(np.float32)
    ray = pos - centres[first]
    d0 = np.linalg.norm(ray, axis=1)
    st["mp_pos"][:M_used] = pos
    st["mp_desc"][:M_used] = desc
    st["mp_normal"][:M_used] = ray / d0[:, None]
    st["mp_min_dist"][:M_used] = d0 / 3
    st["mp_max_dist"][:M_used] = d0 * 1.05
    st["mp_valid"][:M_used] = True
    st["mp_ref_kf"][:M_used] = first
    st["mp_first_kf"][:M_used] = first
    K = st["covis"].shape[0]
    for i in range(M_used):
        ks = st["mp_obs_kf"][i, :st["mp_n_obs"][i]]
        for a in ks:
            for b in ks:
                if a != b:
                    st["covis"][a, b] += 1
    assert K > rev
    st["next_kf"] = np.asarray(len(poses), np.int32)
    st["next_mp"] = np.asarray(M_used, np.int32)
    return st, T_true


def states(st):
    """(JAX MapState, port MapState) of a numpy world."""
    return jms.MapState(**{k: jnp.asarray(v) for k, v in st.items()}), convert.map_state_to_torch(st, "cpu")


def cams(cfg_j, cfg_t):
    return JCam.from_config(cfg_j.camera), TCam.from_config(cfg_t.camera, "cpu")


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def t_sim3(S) -> tsim3.Sim3:
    return convert.sim3_to_torch(np_tree(S), "cpu")


def assert_sim3_close(St, Sj, tol=SIM3_TOL):
    for name in ("R", "t", "s"):
        np.testing.assert_allclose(getattr(St, name).numpy(), np.asarray(getattr(Sj, name)), atol=tol,
                                   err_msg=name)


def assert_maps_agree(jm, tm, point_m=POINT_M, pose_m=POSE_M, pose_deg=POSE_DEG):
    """Integer tables equal, poses and points within tolerance."""
    for f in INT_TABLES:
        a = getattr(tm, f).numpy()
        b = np.asarray(getattr(jm, f))
        np.testing.assert_array_equal(a, b.view(np.int32) if b.dtype == np.uint32 else b, err_msg=f)
    assert int(tm.next_kf) == int(jm.next_kf) and int(tm.next_mp) == int(jm.next_mp)
    Tj, Tt = np.asarray(jm.kf_Tcw), tm.kf_Tcw.numpy()
    assert np.abs(Tj[:, :3, 3] - Tt[:, :3, 3]).max() <= pose_m
    assert rot_deg(Tj, Tt).max() <= pose_deg
    ok = np.asarray(jm.mp_valid)
    np.testing.assert_allclose(tm.mp_pos.numpy()[ok], np.asarray(jm.mp_pos)[ok], atol=point_m)


def closers(cfg_j, cfg_t, st):
    """A LoopCloser of each package with the same vocabulary, trained on the
    world's descriptors."""
    descs = st["kf_desc"][st["kf_feat_valid"]]
    vj = jvoc.train_vocabulary(descs, branching=8, depth=3, seed=0)
    vt = tvoc.train_vocabulary(descs, branching=8, depth=3, seed=0)
    return jlc.LoopCloser(cfg_j, vj), tlc.LoopCloser(cfg_t, vt)


@pytest.fixture(scope="module")
def two():
    """The two-keyframe revisit (keyframe 1 revisits keyframe 0)."""
    cfg_j, cfg_t = make_cfg(jcfg), make_cfg(tcfg)
    cam_j, cam_t = cams(cfg_j, cfg_t)
    st, T_true = loop_world(cfg_j)
    sj, stt = states(st)
    cj, ct = closers(cfg_j, cfg_t, st)
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, cam_j=cam_j, cam_t=cam_t, st=st, sj=sj, stt=stt, cj=cj, ct=ct,
                T_true=T_true)


def stage_a_both(w, sj, stt, kf_cur=1, kf_cand=0, seed=0):
    """Stage A of each package on the same minimal sets."""
    key = jax.random.PRNGKey(seed)
    Sj, okj, bjj, gj = w["cj"]._sim3_a(sj, w["cam_j"], kf_cur, kf_cand, key)
    sets = jax_minimal_sets(key, np.asarray(okj), min_set=3)
    St, okt, bjt, gt = w["ct"].stage_a(stt, w["cam_t"], kf_cur, kf_cand, sets=torch.from_numpy(sets))
    return (Sj, okj, bjj, gj), (St, okt, bjt, gt), sets


# ------------------------------------------------------------- the world --

def test_world_observations_are_exact_projections(two):
    st = two["st"]
    for k in range(int(st["next_kf"])):
        f = st["kf_feat_valid"][k]
        uv, _ = project(st["kf_Tcw"][k], st["mp_pos"][st["kf_mp_idx"][k][f]])
        np.testing.assert_allclose(uv, st["kf_uv"][k][f], atol=2e-3)
    assert st["kf_feat_valid"][1].sum() > 80


# ------------------------------------------------------ module functions --

def test_match_mappoint_features_matches_jax(two):
    outj = jax.jit(jlc.match_mappoint_features)(two["sj"], 1, 0)
    outt = tlc.match_mappoint_features(two["stt"], 1, 0)
    okj, okt = np.asarray(outj[0]), outt[0].numpy()
    np.testing.assert_array_equal(okt, okj)
    assert okj.sum() > 80
    for a, b in zip(outt[1:], outj[1:]):
        a, b = a.numpy(), np.asarray(b)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a[okj], b[okj], atol=1e-4)
        else:
            np.testing.assert_array_equal(a[okj], b[okj])


@pytest.mark.parametrize("seeded", [False, True], ids=["from_empty", "on_matches"])
def test_search_by_sim3_pair_matches_jax(two, seeded):
    """From no seed with the true Sim3 on the shared-point world (nearly
    every correspondence recovered, identity order), and from the
    descriptor matches on the duplicate world (existing > forward >
    backward precedence)."""
    cfg_j = two["cfg_j"]
    N = cfg_j.orb.max_keypoints
    if seeded:
        sj, stt = two["sj"], two["stt"]
        ok, bj, *_ = jax.jit(jlc.match_mappoint_features)(sj, 1, 0)
        ok = np.asarray(ok) & (np.arange(N) % 3 == 0)      # a thin seed
        bj = np.asarray(bj)
        S12 = jsim3.from_se3(jnp.asarray(two["T_true"]))
    else:
        st, T_true = loop_world(cfg_j, share=True, drift=False)
        sj, stt = states(st)
        ok, bj = np.zeros(N, bool), np.full(N, -1, np.int32)
        S12 = jsim3.from_se3(jnp.asarray(T_true))
    fj = jax.jit(partial(jlc.search_by_sim3_pair, **GEOM))
    okj, bjj, nj = fj(sj, two["cam_j"], 1, 0, S12, jnp.asarray(ok), jnp.asarray(bj))
    okt, bjt, nt = tlc.search_by_sim3_pair(stt, two["cam_t"], 1, 0, t_sim3(S12), torch.from_numpy(ok),
                                           torch.from_numpy(bj), **GEOM)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_array_equal(bjt.numpy(), np.asarray(bjj))
    assert int(nt) == int(nj) >= 0.9 * two["st"]["kf_feat_valid"][1].sum()
    if not seeded:   # the matched features hold the same map point
        m = okt.numpy()
        same = st["kf_mp_idx"][0][bjt.numpy()[m]] == st["kf_mp_idx"][1][m]
        assert same.mean() > 0.95


def test_gather_match_pairs_matches_jax(two):
    ok, bj, *_ = jax.jit(jlc.match_mappoint_features)(two["sj"], 1, 0)
    outj = jlc.gather_match_pairs(two["sj"], 1, 0, ok, bj)
    outt = tlc.gather_match_pairs(two["stt"], 1, 0, torch.from_numpy(np.asarray(ok)),
                                  torch.from_numpy(np.asarray(bj)))
    for a, b in zip(outt, outj):
        a, b = a.numpy(), np.asarray(b)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, atol=1e-4)
        else:
            np.testing.assert_array_equal(a, b)


def test_group_snapshot_and_projection_match_jax(two):
    st, T_true = loop_world(two["cfg_j"], share=True, drift=False)
    sj, stt = states(st)
    gj = jlc.loop_group_snapshot(sj, 0, min_covis_weight=1, max_mps=512)
    gt = tlc.loop_group_snapshot(stt, 0, min_covis_weight=1, max_mps=512)
    for name, a in convert.to_numpy(gt).items():
        np.testing.assert_array_equal(a, np.asarray(getattr(gj, name)), err_msg=name)
    S_cw = jsim3.compose(jsim3.from_se3(jnp.asarray(T_true)), jsim3.from_se3(sj.kf_Tcw[0]))
    m0 = np.full(two["cfg_j"].orb.max_keypoints, -1, np.int32)
    mj, nj = jax.jit(partial(jlc.search_loop_group_projection, **GEOM))(
        sj, two["cam_j"], 1, S_cw, gj, jnp.asarray(m0))
    mt, nt = tlc.search_loop_group_projection(stt, two["cam_t"], 1, t_sim3(S_cw), gt, torch.from_numpy(m0),
                                              **GEOM)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert int(nt) == int(nj) >= 0.8 * st["kf_feat_valid"][1].sum()


def test_stages_and_compute_sim3_match_jax(two):
    """Stages A → B → C on the duplicate world: equal gates and tables, the
    same Sim3 within 1e-4, close to the true relative pose; the whole
    cascade accepts."""
    sj, stt = two["sj"], two["stt"]
    (Sj, okj, bjj, gj), (St, okt, bjt, gt), sets = stage_a_both(two, sj, stt)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_array_equal(bjt.numpy(), np.asarray(bjj))
    assert_sim3_close(St, Sj)
    assert int(gj[0]) >= 20 and int(gj[1]) >= 20 and int(gj[2]) == 1

    Sbj, mj, gbj = two["cj"]._sim3_b(sj, two["cam_j"], 1, 0, Sj, okj, bjj)
    Sbt, mt, gbt = two["ct"].stage_b(stt, two["cam_t"], 1, 0, t_sim3(Sj), okt, bjt)
    np.testing.assert_array_equal(gbt.numpy(), np.asarray(gbj))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert_sim3_close(Sbt, Sbj)
    assert int(gbj[0]) >= 50 and int(gbj[1]) >= 50

    mcj, grj, gcj = two["cj"]._sim3_c(sj, two["cam_j"], 1, 0, Sbj, mj)
    mct, grt, gct = two["ct"].stage_c(stt, two["cam_t"], 1, 0, t_sim3(Sbj), torch.from_numpy(np.asarray(mj)))
    np.testing.assert_array_equal(gct.numpy(), np.asarray(gcj))
    np.testing.assert_array_equal(mct.numpy(), np.asarray(mcj))
    np.testing.assert_array_equal(grt.mp_ids.numpy(), np.asarray(grj.mp_ids))

    res = two["ct"].compute_sim3(stt, two["cam_t"], 1, 0, sets=torch.from_numpy(sets))
    resj = two["cj"].compute_sim3(sj, two["cam_j"], 1, 0, jax.random.PRNGKey(0))
    assert res is not None and resj is not None
    assert_sim3_close(res[0], resj[0])
    np.testing.assert_array_equal(res[1].numpy(), np.asarray(resj[1]))
    # the estimate is the drift: the revisit's true pose against its estimate
    T_rel = two["T_true"] @ np.linalg.inv(two["st"]["kf_Tcw"][0])
    np.testing.assert_allclose(res[0].R.numpy(), T_rel[:3, :3], atol=1e-2)
    assert int((res[1] >= 0).sum()) >= 0.8 * two["st"]["kf_feat_valid"][1].sum()


def test_wrong_geometry_candidate_rejected(two):
    """Strong descriptor overlap, scrambled geometry: both packages refuse
    at the same stage, on the same gate counts."""
    st, _ = loop_world(two["cfg_j"], scramble=True)
    sj, stt = states(st)
    (Sj, okj, bjj, gj), (St, okt, bjt, gt), sets = stage_a_both(two, sj, stt)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    assert two["ct"].compute_sim3(stt, two["cam_t"], 1, 0, sets=torch.from_numpy(sets)) is None
    assert two["cj"].compute_sim3(sj, two["cam_j"], 1, 0, jax.random.PRNGKey(0)) is None


def test_attach_matched_mps_merges_duplicates(two):
    """Feature i of the revisit keyframe ↔ loop point i: every duplicate
    merges away, keyframe 0's slots now hold the revisit's points, the two
    keyframes become covisible; equal to JAX table for table."""
    st = two["st"]
    P = int(st["kf_feat_valid"][1].sum())
    N = st["kf_mp_idx"].shape[1]
    matched = np.where(np.arange(N) < P, st["kf_mp_idx"][0][np.minimum(np.arange(N), N - 1)], -1)
    matched = np.where(np.isin(np.arange(N), np.arange(P)), matched, -1).astype(np.int32)
    # the duplicates of feature f of kf 1 are the kf 0 points of the same descriptor
    dj = jax.jit(jlc.attach_matched_mps)(two["sj"], 1, jnp.asarray(matched))
    dt = tlc.attach_matched_mps(two["stt"], 1, torch.from_numpy(matched))
    assert_maps_agree(dj, dt)
    assert int(dt.mp_valid.sum()) < int(two["stt"].mp_valid.sum())
    assert int(dt.covis[1, 0]) > 0


def test_detect_resolve_matches_jax(two):
    """The consistency chains over one sequence of fetched candidate rows:
    equal candidates and chains after every resolve, the keyframe window
    and frame-level queries included."""
    K = two["cfg_j"].map.max_keyframes
    r = np.random.default_rng(5)
    cj, ct = jlc.LoopCloser(two["cfg_j"], two["cj"].vocab), tlc.LoopCloser(two["cfg_t"], two["ct"].vocab)
    seq = []
    for step in range(8):
        rows = np.zeros((5, 1 + K), np.int32)
        n = r.integers(0, 4)
        rows[:, 0] = -1
        rows[:n, 0] = r.choice(K, n, replace=False)
        rows[:n, 1:] = np.where(r.random((n, K)) < 0.4, 20, 3)
        seq.append((12 + step, rows, step % 3 == 2))
    seq[3][1][0, 0] = seq[2][1][0, 0] if seq[2][1][0, 0] >= 0 else 1
    for kf, rows, is_frame in seq:
        a = cj.detect_resolve(kf, rows, kf_window=not is_frame)
        b = ct.detect_resolve(kf, rows, kf_window=not is_frame)
        assert a == b
        assert ct.consistent_groups == cj.consistent_groups
    cj.last_loop_kf = ct.last_loop_kf = 15
    assert cj.detect_resolve(20, seq[0][1]) is None and ct.detect_resolve(20, seq[0][1]) is None


def test_warmup_leaves_state_bit_identical(two):
    stt = two["stt"]
    ct = tlc.LoopCloser(two["cfg_t"], two["ct"].vocab)
    before = [x.clone() for x in stt]
    ct.warmup(stt, two["cam_t"])
    for name, a, b in zip(stt._fields, stt, before):
        assert torch.equal(a, b), name
    assert ct.last_loop_kf == -1 and ct.consistent_groups == []


# --------------------------------------------- correction, essential graph --

@pytest.fixture(scope="module")
def ring():
    """The 12-keyframe world (chain 0-10, revisit 11) and the verified
    cascade's output of JAX, carried to the port."""
    cfg_j, cfg_t = make_cfg(jcfg, K=16, M=2048), make_cfg(tcfg, K=16, M=2048)
    cam_j, cam_t = cams(cfg_j, cfg_t)
    st, T_true = loop_world(cfg_j, n_chain=11, P=100)
    sj, stt = states(st)
    cj, ct = closers(cfg_j, cfg_t, st)
    res = cj.compute_sim3(sj, cam_j, 11, 0, jax.random.PRNGKey(11))
    assert res is not None
    S12, matched, group = res
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, cam_j=cam_j, cam_t=cam_t, st=st, sj=sj, stt=stt, cj=cj, ct=ct,
                S12=S12, matched=matched, group=group)


def test_correct_group_and_essential_edges_match_jax(ring):
    sj, stt = ring["sj"], ring["stt"]
    mw = ring["cfg_j"].mapping.min_covis_weight
    outj = jlc.correct_group(sj, 11, 0, ring["S12"], min_covis_weight=mw)
    outt = tlc.correct_group(stt, 11, 0, t_sim3(ring["S12"]), min_covis_weight=mw)
    assert_maps_agree(outj[0], outt[0])
    assert_sim3_close(outt[1], outj[1], tol=1e-6)
    np.testing.assert_array_equal(outt[2].numpy(), np.asarray(outj[2]))
    assert np.asarray(outj[2]).sum() >= 2 and int(outt[0].loop_edges[0, 0]) == 11
    for budget in (4096, 16 + 64 + 1 + 3):   # room for every covisibility edge, and for 3
        ej = jlc.collect_essential_edges(outj[0], 100, budget)
        et = tlc.collect_essential_edges(outt[0], 100, budget)
        for a, b in zip(et, ej):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (np.asarray(ej[0]) >= 0).sum() > 11


@pytest.mark.parametrize("route", ["dense", "pcg"])
def test_optimize_essential_matches_jax(ring, route):
    """The essential graph after correction + attach, through both pose
    graph routes (``dense_max_k=0`` forces PCG on this 16-slot map)."""
    sj, stt = ring["sj"], ring["stt"]
    mw = ring["cfg_j"].mapping.min_covis_weight
    pre_j = sj.covis > 0
    s1j, S_nc, gmask = jlc.correct_group(sj, 11, 0, ring["S12"], min_covis_weight=mw)
    s2j = jax.jit(jlc.attach_matched_mps)(s1j, 11, ring["matched"])
    kw = dict(iters=20) if route == "dense" else dict(iters=20, dense_max_k=0)
    ej = jax.jit(partial(jlc.optimize_essential, essential_weight=100, pose_graph_fn=partial(j_opg, **kw)))(
        s2j, 11, 0, ring["S12"], S_nc, gmask, pre_j)
    s2t = convert.map_state_to_torch(np_tree(s2j), "cpu")
    et = tlc.optimize_essential(s2t, 11, 0, t_sim3(ring["S12"]), t_sim3(S_nc),
                                torch.from_numpy(np.asarray(gmask)), torch.from_numpy(np.asarray(pre_j)),
                                essential_weight=100, pose_graph_fn=partial(t_opg, **kw))
    assert_maps_agree(ej, et, point_m=5e-3, pose_m=1e-3)
    moved = np.abs(np.asarray(ej.kf_Tcw)[1:11, :3, 3] - np.asarray(s2j.kf_Tcw)[1:11, :3, 3]).max()
    assert moved > 1e-3, "the essential graph did not spread the correction"


def test_fuse_group_into_kfs_matches_jax(ring):
    sj = ring["sj"]
    kf_ids = [11, 10, -1]
    fj = jax.jit(partial(jlc.fuse_group_into_kfs, **GEOM))(
        sj, ring["cam_j"], ring["group"], jnp.asarray(kf_ids + [-1] * 13, jnp.int32))
    gt = convert.local_map_to_torch(np_tree(ring["group"]), "cpu")
    ft = tlc.fuse_group_into_kfs(ring["stt"], ring["cam_t"], gt, kf_ids, **GEOM)
    assert_maps_agree(fj, ft)


def test_correct_matches_jax(ring):
    """LoopCloser.correct (no GBA) from the same cascade output: the map
    table for table; the closer's chain state reset alike."""
    cj, ct = ring["cj"], ring["ct"]
    outj = cj.correct(ring["sj"], ring["cam_j"], 11, 0, ring["S12"], ring["matched"], ring["group"],
                      run_gba=False)
    gt = convert.local_map_to_torch(np_tree(ring["group"]), "cpu")
    outt = ct.correct(ring["stt"], ring["cam_t"], 11, 0, t_sim3(ring["S12"]),
                      torch.from_numpy(np.asarray(ring["matched"])), gt, run_gba=False)
    assert_maps_agree(outj, outt, point_m=5e-3, pose_m=1e-3)
    assert ct.last_loop_kf == cj.last_loop_kf == 11 and ct.consistent_groups == []
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        ct.correct(ring["stt"], ring["cam_t"], 11, 0, t_sim3(ring["S12"]),
                   torch.from_numpy(np.asarray(ring["matched"])), gt, mesh=object())


def test_detection_rows_match_jax(ring):
    """Registration of keyframes 0-10, then the keyframe query of 11 and a
    frame-level query: equal database rows and candidate rows; keyframe 0
    comes first."""
    cj = jlc.LoopCloser(ring["cfg_j"], ring["cj"].vocab)
    ct = tlc.LoopCloser(ring["cfg_t"], ring["ct"].vocab)
    for k in range(11):
        cj.add_keyframe_to_db(ring["sj"], k)
        ct.add_keyframe_to_db(ring["stt"], k)
    oj = cj.detect_async(ring["sj"], 11)
    ot = ct.detect_async(ring["stt"], 11)
    np.testing.assert_array_equal(tlc._fetch(ot), np.asarray(oj))
    np.testing.assert_array_equal(ct.db.word_ids.numpy(), np.asarray(cj.db.word_ids))
    np.testing.assert_allclose(ct.db.weights.numpy(), np.asarray(cj.db.weights), atol=1e-6)
    assert int(np.asarray(oj)[0, 0]) == 0
    sj, stt = ring["sj"], ring["stt"]
    fj = cj.detect_frame_async(sj, sj.kf_desc[11], sj.kf_feat_valid[11], 11)
    ft = ct.detect_frame_async(stt, stt.kf_desc[11], stt.kf_feat_valid[11], 11)
    np.testing.assert_array_equal(tlc._fetch(ft), np.asarray(fj))
    assert ct.detect_frame_async(stt, stt.kf_desc[3], stt.kf_feat_valid[3], 3) is None
    assert ct.detect_async(stt, 5) is None   # a young map registers without a query
