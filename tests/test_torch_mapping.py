"""Parity of the port's local-mapping modules with the JAX package's, on the
CPU, at the small mapping configuration of ``tests/test_slam_e2e.py``.

The module fixture runs the JAX ``SLAM`` in mapping mode without loop
closing over a few rendered frames, with its fused keyframe programs
replaced by the same module functions jitted one by one
(``use_module_programs``: the module tests below reuse those compiles).  The last keyframe's front half and its
deferred tail record every intermediate map state; each port function then
runs on the carried-over input of its JAX counterpart
(``convert.map_state_to_torch``) and the outputs are compared:

* integer tables (``kf_mp_idx``, ``mp_obs_kf``, ``mp_n_obs``, ``kf_valid``,
  ``kf_parent``, ``covis``, ``mp_valid``) and the bump pointers are equal —
  no float decision flips on this state, so the budget is 0 entries;
* keyframe poses within 1 mm / 0.01°, map points within 5 mm, descriptors
  and the other tables exact;
* geometry helpers on seeded random inputs to f32 rounding (closed-form
  eigenvalues to 1e-4 of the largest).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orb_slam2_ros2_tpu.config as jcfg
import orb_slam2_ros2_tpu_torch.config as tcfg
from orb_slam2_ros2_tpu.geometry import camera as jcam
from orb_slam2_ros2_tpu.geometry import triangulate as jtri
from orb_slam2_ros2_tpu.io.synthetic import SyntheticStereoDataset
from orb_slam2_ros2_tpu.mapstate import map_state as jms
from orb_slam2_ros2_tpu.mapstate import mapping as jmap
from orb_slam2_ros2_tpu.pipeline.system import SLAM as JSLAM
from orb_slam2_ros2_tpu.solvers import local_ba as jlba
from orb_slam2_ros2_tpu_torch import convert
from orb_slam2_ros2_tpu_torch.geometry import camera as tcam
from orb_slam2_ros2_tpu_torch.geometry import triangulate as ttri
from orb_slam2_ros2_tpu_torch.mapstate import local_map as tlm
from orb_slam2_ros2_tpu_torch.mapstate import map_state as tms
from orb_slam2_ros2_tpu_torch.mapstate import mapping as tmap

N_FRAMES = 6
INT_TABLES = ("kf_mp_idx", "mp_obs_kf", "mp_n_obs", "kf_valid", "kf_parent", "covis", "mp_valid")
POSE_TOL_M, POSE_TOL_DEG = 1e-3, 0.01
POINT_TOL_M = 5e-3


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two torch intra-op threads while a module's tests run: the suite runs
    six pytest workers on the cores, and an OpenMP pool of every core in
    each worker oversubscribes them (the seven torch test files took 890 s
    in parallel with the default pools, 74 s with two threads each)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_cfg(mod, **mapping):
    """The mapping configuration of ``tests/test_slam_e2e.py``."""
    cfg = mod.SLAMConfig(
        camera=mod.CameraConfig(fx=200.0, fy=200.0, cx=160.0, cy=96.0, baseline=0.5,
                                width=320, height=192),
        orb=mod.ORBConfig(n_features=600, max_keypoints=768),
        tracking=mod.TrackingConfig(min_init_depth_kps=150, max_local_mappoints=4096,
                                    max_local_keyframes=16),
        map=mod.MapConfig(max_keyframes=64, max_mappoints=16384, max_obs_per_mp=16),
        ba=mod.BAConfig(**jax_local_ba(mod)),
    )
    return cfg.replace(mapping=dataclasses.replace(cfg.mapping, **mapping))


def jax_local_ba(mod) -> dict:
    """``BAConfig`` fields that give the port's local BA JAX's outlier
    removal (the free keyframes' alone), for the configurations the tests
    run on both systems; nothing for JAX's module."""
    names = {f.name for f in dataclasses.fields(mod.BAConfig)}
    return {"local_ba_erase_in_anchors": False} if "local_ba_erase_in_anchors" in names else {}


def jax_modules(cfg):
    """The JAX keyframe-program modules, each jitted on its own, with the
    arguments ``SLAM`` gives them."""
    c, o, t, mp, b = cfg.camera, cfg.orb, cfg.tracking, cfg.mapping, cfg.ba
    common = dict(scale_factor=o.scale_factor, n_levels=o.n_levels)
    return dict(
        insert=jax.jit(partial(jms.insert_keyframe, depth_threshold=c.baseline * t.th_depth,
                               min_covis_weight=mp.min_covis_weight,
                               seed_floor=mp.seed_far_floor, **common)),
        cull_mp=jax.jit(partial(jmap.cull_mappoints, cull_score=mp.mp_cull_score)),
        triangulate=jax.jit(partial(jmap.triangulate_new_points, n_neighbors=mp.n_triangulate_kfs,
                                    baseline=c.baseline, rank_gate=mp.triangulation_rank_gate,
                                    chi2_mono=b.chi2_mono, chi2_stereo=b.chi2_stereo, **common)),
        fuse=jax.jit(partial(jmap.fuse_into_keyframe, width=c.width, height=c.height, **common)),
        fuse_back=jax.jit(partial(jmap.fuse_keyframe_into_neighbors, width=c.width,
                                  height=c.height, n_neighbors=mp.backward_fuse_neighbors,
                                  allow_merge=mp.backward_fuse_merge, **common)),
        local_ba=jax.jit(partial(jlba.local_ba, max_free=b.max_local_ba_kfs,
                                 max_fixed=b.max_local_ba_fixed, max_points=b.local_ba_points,
                                 chi2_mono=b.chi2_mono, chi2_stereo=b.chi2_stereo,
                                 lam=b.lm_lambda_init, scale_factor=o.scale_factor,
                                 phase_iters=tuple(b.local_ba_phase_iters))),
        cull_kf=jax.jit(partial(jmap.cull_keyframes, redundancy=mp.kf_cull_ratio,
                                n_candidates=mp.kf_cull_candidates)),
    )


def torch_modules(cfg, cam):
    """The port's modules with the arguments its ``SLAM`` gives them;
    ``kf`` is a host int or an int32 [1] tensor."""
    from orb_slam2_ros2_tpu_torch.solvers.local_ba import local_ba

    c, o, t, mp, b = cfg.camera, cfg.orb, cfg.tracking, cfg.mapping, cfg.ba
    common = dict(scale_factor=o.scale_factor, n_levels=o.n_levels)
    return dict(
        cull_mp=lambda s, kf: tmap.cull_mappoints(s, kf, cull_score=mp.mp_cull_score),
        triangulate=lambda s, kf: tmap.triangulate_new_points(
            s, kf, cam, n_neighbors=mp.n_triangulate_kfs, baseline=c.baseline,
            rank_gate=mp.triangulation_rank_gate, chi2_mono=b.chi2_mono,
            chi2_stereo=b.chi2_stereo, **common),
        fuse=lambda s, kf: tmap.fuse_into_keyframe(s, kf, cam, width=c.width, height=c.height, **common),
        fuse_back=lambda s, kf: tmap.fuse_keyframe_into_neighbors(
            s, kf, cam, width=c.width, height=c.height, n_neighbors=mp.backward_fuse_neighbors,
            allow_merge=mp.backward_fuse_merge, **common),
        local_ba=lambda s, kf: local_ba(
            s, kf, cam, max_free=b.max_local_ba_kfs, max_fixed=b.max_local_ba_fixed,
            max_points=b.local_ba_points, chi2_mono=b.chi2_mono, chi2_stereo=b.chi2_stereo,
            lam=b.lm_lambda_init, scale_factor=o.scale_factor,
            phase_iters=tuple(b.local_ba_phase_iters)),
        cull_kf=lambda s, kf: tmap.cull_keyframes(s, kf, redundancy=mp.kf_cull_ratio,
                                                  n_candidates=mp.kf_cull_candidates),
    )


def use_module_programs(slam, record: dict):
    """Replace a JAX ``SLAM``'s fused keyframe programs by the same module
    functions jitted one by one (``jax_modules``, whose compiles the tests
    reuse), called in the fused programs' order.  ``record`` maps each stage
    to the map state it produced — the front half's of the last keyframe,
    the last deferred tail's and the last aborted BA's keyframe cull —
    with "pre" the last insertion's inputs, "tail" and "abort_cull_in" the
    input states, "kf" the last keyframe id.  Returns the modules."""
    P = jax_modules(slam.cfg)

    def front(mapstate, frame, Tcw, mp_ids, fid, cam):
        record["pre"] = (mapstate, frame, Tcw, mp_ids, fid)
        s, kf = P["insert"](mapstate, frame, Tcw, mp_ids, fid, cam)
        record["kf"], record["insert"] = int(kf), s
        for name in ("cull_mp", "triangulate", "fuse", "fuse_back"):
            s = P[name](s, kf) if name == "cull_mp" else P[name](s, kf, cam)
            record[name] = s
        return s, kf, slam._snapshot(s, kf), s.kf_mp_idx[kf], s.kf_Tcw[kf]

    def tail(mapstate, kf_id, cam, do_ba, do_cull):
        record["tail"] = mapstate
        Tcw_before = mapstate.kf_Tcw[kf_id]
        if do_ba:
            mapstate = P["local_ba"](mapstate, kf_id, cam)
            record["local_ba"] = mapstate
        if do_cull:
            mapstate = P["cull_kf"](mapstate, kf_id)
            record["cull_kf"] = mapstate
        return mapstate, slam._snapshot(mapstate, kf_id), Tcw_before

    def abort_cull(mapstate, kf_id):
        record["abort_cull_in"] = (mapstate, int(kf_id))
        record["abort_cull"] = P["cull_kf"](mapstate, kf_id)
        return record["abort_cull"]

    slam._map_front = front
    slam._map_tail_variants = {(ba, cull): partial(tail, do_ba=ba, do_cull=cull)
                               for ba in (True, False) for cull in (True, False)}
    slam._cull_kfs = abort_cull
    return P


def run_jax_mapping(cfg, n_frames=N_FRAMES):
    """Run the JAX SLAM in mapping mode (no loop closing) on its module
    programs (``use_module_programs``) and flush.  Returns (slam, modules,
    record)."""
    slam = JSLAM(cfg, enable_loop_closing=False)
    record = {}
    P = use_module_programs(slam, record)
    ds = SyntheticStereoDataset(cfg.camera, n_frames=n_frames, speed=0.35)
    for i in range(n_frames):
        pose, _ = slam.track(*ds.frame(i)[:2])
        assert pose is not None, f"JAX reference lost track at frame {i}"
    slam.flush()
    return slam, P, record


def to_torch(state):
    return convert.map_state_to_torch(state, "cpu")


def rot_deg(A, B):
    dR = np.asarray(A, np.float64)[..., :3, :3].swapaxes(-1, -2) @ np.asarray(B, np.float64)[..., :3, :3]
    s = 0.5 * np.linalg.norm(np.stack([dR[..., 2, 1] - dR[..., 1, 2], dR[..., 0, 2] - dR[..., 2, 0],
                                       dR[..., 1, 0] - dR[..., 0, 1]], -1), axis=-1)
    return np.degrees(np.arcsin(np.clip(s, 0.0, 1.0)))


def table_diffs(jm, tm) -> dict:
    """Per integer table, the number of entries that differ."""
    return {f: int(np.sum(np.asarray(getattr(jm, f)) != getattr(tm, f).numpy())) for f in INT_TABLES}


def assert_maps_agree(jm, tm, budget: int = 0, pose_m=POSE_TOL_M, pose_deg=POSE_TOL_DEG,
                      point_m=POINT_TOL_M, point_quantile=1.0):
    """The JAX map ``jm`` and the port's ``tm`` agree: bump pointers equal,
    each integer table within ``budget`` differing entries, descriptors of
    points valid in both equal, poses and points within tolerance
    (``point_quantile`` of the points within ``point_m``)."""
    assert int(tm.next_kf) == int(jm.next_kf)
    assert int(tm.next_mp) == int(jm.next_mp)
    diffs = table_diffs(jm, tm)
    assert max(diffs.values()) <= budget, diffs
    kv = np.asarray(jm.kf_valid) & tm.kf_valid.numpy()
    Tj, Tt = np.asarray(jm.kf_Tcw)[kv], tm.kf_Tcw.numpy()[kv]
    assert np.abs(Tj[:, :3, 3] - Tt[:, :3, 3]).max() <= pose_m
    assert rot_deg(Tj, Tt).max() <= pose_deg
    both = np.asarray(jm.mp_valid) & tm.mp_valid.numpy()
    d = np.abs(np.asarray(jm.mp_pos)[both] - tm.mp_pos.numpy()[both]).max(1)
    assert np.quantile(d, point_quantile) <= point_m, np.sort(d)[-10:]
    np.testing.assert_array_equal(np.asarray(jm.mp_desc)[both].view(np.int32), tm.mp_desc.numpy()[both])
    np.testing.assert_array_equal(np.asarray(jm.mp_obs_feat), tm.mp_obs_feat.numpy())


@pytest.fixture(scope="module")
def world():
    cfg_j, cfg_t = small_cfg(jcfg), small_cfg(tcfg)
    slam, P, record = run_jax_mapping(cfg_j)
    cam_t = tcam.CameraParams.from_config(cfg_t.camera, "cpu")
    return dict(cfg=cfg_t, slam=slam, P=P, rec=record, cam_j=slam.cam, cam_t=cam_t,
                T=torch_modules(cfg_t, cam_t))


def test_jax_reference_builds_a_map(world):
    """The recorded keyframe sits in a map of several keyframes, and every
    stage under test changes the state it is given."""
    rec = world["rec"]
    assert rec["kf"] == N_FRAMES - 1 and world["slam"].n_keyframes >= 4
    assert int(rec["triangulate"].next_mp) > int(rec["cull_mp"].next_mp)
    for a, b in (("insert", "cull_mp"), ("triangulate", "fuse"), ("fuse", "fuse_back")):
        assert any(table_diffs(rec[a], to_torch(rec[b])).values()), (a, b)


# ------------------------------------------------------ geometry/triangulate --

def _rotation(phi):
    """Rodrigues: rotation vectors [n, 3] → matrices [n, 3, 3] (float64)."""
    th = np.linalg.norm(phi, axis=1)[:, None, None]
    K = np.zeros((len(phi), 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -phi[:, 2], phi[:, 1], -phi[:, 0]
    K = K - K.transpose(0, 2, 1)
    return np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th ** 2 * K @ K


def _random_views(r, n):
    """Camera pairs with a 0.5-2 m sideways baseline; the first 8 pairs are
    one view twice (a rank-deficient DLT system)."""
    T1 = np.tile(np.eye(4), (n, 1, 1))
    T1[:, :3, :3] = _rotation(r.normal(0, 0.05, (n, 3)))
    T1[:, :3, 3] = r.normal(0, 0.05, (n, 3))
    step = np.tile(np.eye(4), (n, 1, 1))
    step[:, :3, :3] = _rotation(r.normal(0, 0.02, (n, 3)))
    step[:, :3, 3] = np.concatenate([r.uniform(0.5, 2.0, (n, 1)), r.normal(0, 0.1, (n, 2))], 1)
    step[:8] = np.eye(4)
    return T1.astype(np.float32), (step @ T1).astype(np.float32)


def test_triangulate_helpers_match_jax():
    cfg_j = small_cfg(jcfg)
    cam_j = jcam.CameraParams.from_config(cfg_j.camera)
    cam_t = tcam.CameraParams.from_config(small_cfg(tcfg).camera, "cpu")
    r = np.random.default_rng(0)
    n = 256
    T1, T2 = _random_views(r, n)
    pw = np.concatenate([r.uniform(-3, 3, (n, 2)), r.uniform(2, 12, (n, 1))], 1).astype(np.float32)
    c = cfg_j.camera

    def project(T):
        pc = np.einsum("nij,nj->ni", T[:, :3, :3], pw) + T[:, :3, 3]
        return np.stack([c.fx * pc[:, 0] / pc[:, 2] + c.cx, c.fy * pc[:, 1] / pc[:, 2] + c.cy],
                        1).astype(np.float32)

    uv1, uv2 = project(T1), project(T2)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731

    np.testing.assert_allclose(ttri.dlt_rows(cam_t, t(T1), t(uv1)).numpy(),
                               np.asarray(jtri.dlt_rows(cam_j, T1, uv1)), rtol=1e-6, atol=1e-6)
    pj, okj = jax.jit(jtri.triangulate_pairs)(cam_j, T1, uv1, T2, uv2, 1e-3)
    pt, okt = ttri.triangulate_pairs(cam_t, t(T1), t(uv1), t(T2), t(uv2), 1e-3)
    # the gate compares λ_min/λ_max of AᵀA with 1e-6.  AᵀA is formed in f32,
    # so below about twice the gate the ratio is rounding noise in both
    # packages: the decisions must agree on the pairs clearly above it and
    # on the rank-deficient ones
    A = np.concatenate([np.asarray(jtri.dlt_rows(cam_j, T1, uv1)),
                        np.asarray(jtri.dlt_rows(cam_j, T2, uv2))], 1).astype(np.float64)
    lam = np.linalg.eigvalsh(A[..., :3].swapaxes(1, 2) @ A[..., :3])
    clear = (lam[:, 0] > 2e-6 * lam[:, 2]) | (np.arange(n) < 8)
    assert clear.sum() > 0.9 * n
    ok = np.asarray(okj)
    np.testing.assert_array_equal(okt.numpy()[clear], ok[clear])
    ok = ok & okt.numpy()
    assert ok.sum() > n // 2 and not ok[:8].any()
    np.testing.assert_allclose(pt.numpy()[ok], np.asarray(pj)[ok], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pt.numpy()[ok], pw[ok], rtol=0, atol=5e-2)

    nrm = lambda uv: (uv - [c.cx, c.cy]) / [c.fx, c.fy]  # noqa: E731
    n1, n2 = nrm(uv1).astype(np.float32), nrm(uv2).astype(np.float32)
    np.testing.assert_allclose(ttri.parallax_cos(t(T1), t(n1), t(T2), t(n2)).numpy(),
                               np.asarray(jtri.parallax_cos(T1, n1, T2, n2)), atol=1e-6)
    np.testing.assert_allclose(ttri.depth_in_view(t(T1), t(pw)).numpy(),
                               np.asarray(jtri.depth_in_view(T1, pw)), rtol=1e-6, atol=1e-5)


def test_sym3_eigenvalues_match_jax():
    r = np.random.default_rng(1)
    A = r.normal(0, 1, (512, 3, 3)).astype(np.float32)
    M = A @ A.swapaxes(1, 2)
    M[:4] = np.diag([1.0, 1.0, 1.0]).astype(np.float32)  # repeated eigenvalues
    lj = np.stack(jtri._sym3_eigenvalues(jnp.asarray(M)), -1)
    lt = torch.stack(ttri._sym3_eigenvalues(torch.from_numpy(M)), -1).numpy()
    scale = np.abs(lj).max(-1, keepdims=True)
    np.testing.assert_allclose(lt / scale, lj / scale, atol=1e-4)
    np.testing.assert_allclose(lt / scale, np.linalg.eigvalsh(M.astype(np.float64)) / scale, atol=1e-3)


# ------------------------------------------------------------ map_state ---

def test_grow_map_matches_jax(world):
    s = world["rec"]["fuse_back"]
    K, M = s.kf_valid.shape[0], s.mp_valid.shape[0]
    gj = jms.grow_map(s, kf_capacity=2 * K, mp_capacity=M + 512)
    gt = tms.grow_map(to_torch(s), kf_capacity=2 * K, mp_capacity=M + 512)
    for name, a in convert.to_numpy(gt).items():
        np.testing.assert_array_equal(a, np.asarray(getattr(gj, name)), err_msg=name)
    assert tms.grow_map(to_torch(s)) is not None
    with pytest.raises(ValueError):
        tms.grow_map(to_torch(s), kf_capacity=K - 1)


@pytest.mark.parametrize("dup", ["unique", "repeated_losers"])
def test_merge_mappoints_matches_jax(world, dup):
    """Batched MapPoint::replace, with rows that are no-ops (masked off,
    winner == loser) and, in the second case, losers named by several rows
    (the first row's winner takes it)."""
    s = world["rec"]["fuse_back"]
    ids = np.flatnonzero(np.asarray(s.mp_valid)).astype(np.int32)
    r = np.random.default_rng(2)
    pick = r.permutation(ids)[:128]
    winner, loser = pick[:64].copy(), pick[64:].copy()
    mask = r.random(64) < 0.8
    winner[5] = loser[5]
    if dup == "repeated_losers":
        loser[10:14] = loser[9]
    jout = jax.jit(jms.merge_mappoints)(s, jnp.asarray(winner), jnp.asarray(loser), jnp.asarray(mask))
    tout = tms.merge_mappoints(to_torch(s), torch.from_numpy(winner), torch.from_numpy(loser),
                               torch.from_numpy(mask))
    for name, a in convert.to_numpy(tout).items():
        np.testing.assert_array_equal(a, np.asarray(getattr(jout, name)), err_msg=name)
    assert not tout.mp_valid[torch.from_numpy(loser[mask & (winner != loser)]).long()].any()


# ------------------------------------------------------------- mapping ----

STAGES = [("cull_mp", "insert"), ("triangulate", "cull_mp"), ("fuse", "triangulate"),
          ("fuse_back", "fuse")]


def kf_arg(kind, kf):
    """A keyframe id as a host int or as an int32 [1] tensor (the captured
    keyframe programs' form)."""
    return int(kf) if kind == "int" else torch.tensor([int(kf)], dtype=torch.int32)


@pytest.mark.parametrize("ids", ["int", "tensor"])
@pytest.mark.parametrize("stage,source", STAGES, ids=[s for s, _ in STAGES])
def test_front_stage_matches_jax(world, stage, source, ids):
    """One stage of the keyframe front half on the state the JAX stage
    before it produced, the keyframe id a host int or an int32 [1] tensor."""
    rec = world["rec"]
    out = world["T"][stage](to_torch(rec[source]), kf_arg(ids, rec["kf"]))
    assert_maps_agree(rec[stage], out)


def test_insert_stage_matches_jax(world):
    """Keyframe insertion at the head of the front half, with the
    configured far-point seed floor."""
    cfg = world["cfg"]
    c, o, t, mp = cfg.camera, cfg.orb, cfg.tracking, cfg.mapping
    state, frame, Tcw, mp_ids, fid = world["rec"]["pre"]
    out, kf = tms.insert_keyframe(
        to_torch(state), convert.stereo_frame_to_torch(frame, "cpu"), torch.from_numpy(np.array(Tcw)),
        torch.from_numpy(np.array(mp_ids)), int(fid), world["cam_t"],
        depth_threshold=c.baseline * t.th_depth, scale_factor=o.scale_factor, n_levels=o.n_levels,
        min_covis_weight=mp.min_covis_weight, seed_floor=mp.seed_far_floor)
    assert int(kf) == world["rec"]["kf"]
    assert_maps_agree(world["rec"]["insert"], out)


def test_fundamental_matrix_matches_jax(world):
    s = world["rec"]["fuse_back"]
    Tj = np.array(s.kf_Tcw)[: world["rec"]["kf"] + 1]
    Fj = np.asarray(jax.jit(jmap._fundamental_from_poses)(world["cam_j"], Tj[-1], Tj))
    Ft = tmap._fundamental_from_poses(world["cam_t"], torch.from_numpy(Tj[-1]), torch.from_numpy(Tj)).numpy()
    np.testing.assert_allclose(Ft, Fj, rtol=1e-4, atol=1e-7)


def test_fuse_keyframe_into_neighbors_with_merge_matches_jax(world):
    """Backward fuse that also merges occupied slots (the configured one,
    covered by the stage test above, only attaches)."""
    cfg = world["cfg"]
    rec = world["rec"]
    kw = dict(width=cfg.camera.width, height=cfg.camera.height,
              n_neighbors=cfg.mapping.backward_fuse_neighbors, allow_merge=True)
    jout = jax.jit(partial(jmap.fuse_keyframe_into_neighbors, **kw))(
        rec["fuse"], jnp.int32(rec["kf"]), world["cam_j"])
    tout = tmap.fuse_keyframe_into_neighbors(to_torch(rec["fuse"]), rec["kf"], world["cam_t"], **kw)
    assert table_diffs(rec["fuse_back"], tout)["mp_valid"] > 0  # some points merged away
    assert_maps_agree(jout, tout)


def test_fuse_candidates_into_keyframe_matches_jax(world):
    """The candidate-set fuse under ``loop_priority`` (the loop closer's
    form; the forward fuse stage above runs it without), on the state
    before the forward fuse, of a neighbour's local map into the new
    keyframe: attaches to empty slots and merges occupied ones always in the
    candidate's favour."""
    from orb_slam2_ros2_tpu.mapstate.local_map import local_map_snapshot as jsnap

    cfg = world["cfg"]
    rec = world["rec"]
    kf, src, s = rec["kf"], rec["kf"] - 1, rec["triangulate"]
    kw = dict(width=cfg.camera.width, height=cfg.camera.height, loop_priority=True)
    local_j = jax.jit(partial(jsnap, max_kfs=8, max_mps=2048))(s, jnp.int32(src))
    jout = jax.jit(partial(jmap.fuse_candidates_into_keyframe, **kw))(
        s, jnp.int32(kf), world["cam_j"], local_j)
    local_t = tlm.local_map_snapshot(to_torch(s), src, max_kfs=8, max_mps=2048)
    tout = tmap.fuse_candidates_into_keyframe(to_torch(s), kf, world["cam_t"], local_t, **kw)
    assert table_diffs(s, tout)["kf_mp_idx"] > 0
    assert_maps_agree(jout, tout)


def test_cull_keyframes_matches_jax(world):
    """The configured keyframe cull after the final local BA."""
    rec = world["rec"]
    out = world["T"]["cull_kf"](to_torch(rec["local_ba"]), rec["kf"])
    assert_maps_agree(rec["cull_kf"], out)


_jax_cull_keyframes = jax.jit(jmap.cull_keyframes, static_argnames=("n_candidates",))


@pytest.mark.parametrize("ids", ["int", "tensor"])
@pytest.mark.parametrize("redundancy", [0.3, 0.2])
def test_cull_keyframes_that_remove_keyframes_match_jax(world, redundancy, ids):
    """Lower redundancy gates cull keyframes, reparent their children and
    freeze their poses relative to the parents, as the JAX package does
    (the keyframe id a host int or an int32 [1] tensor)."""
    rec = world["rec"]
    kw = dict(redundancy=redundancy, n_candidates=6)
    jout = _jax_cull_keyframes(rec["local_ba"], jnp.int32(rec["kf"]), **kw)
    tout = tmap.cull_keyframes(to_torch(rec["local_ba"]), kf_arg(ids, rec["kf"]), **kw)
    assert int(tout.kf_valid.sum()) < int(np.asarray(rec["local_ba"].kf_valid).sum())
    assert_maps_agree(jout, tout)
    np.testing.assert_allclose(tout.kf_Tcp.numpy(), np.asarray(jout.kf_Tcp), atol=1e-5)
