"""Parity of the port's global bundle adjustment (``solvers/pcg_ba.py``'s
PCG-Schur engine and ``solvers/global_ba.py``) with the JAX package's, on
the CPU, on a map the JAX ``SLAM`` builds in mapping mode over six rendered
frames (the fixture of ``tests/test_torch_mapping.py``).

* ``extract_global_problem`` and ``point_to_global``: every table equal,
  also when a small feature capacity drops edges from both views;
* one GN step, the two-phase solve and the chunked start → step → commit:
  keyframe poses within 1e-4 m / 1e-3°, points within 1 mm + 2e-4 of
  their coordinate (the f32 rounding of 20 PCG iterations summed in another
  order, largest on the far points), gates within 2 entries and snapshot
  tables equal;
* a commit onto a map that gained a keyframe and points after the
  snapshot: the new keyframe follows its parent's correction as in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mapping import (  # noqa: F401  (two_torch_threads: autouse)
    rot_deg,
    run_jax_mapping,
    small_cfg,
    to_torch,
    two_torch_threads,
)

import orb_slam2_ros2_tpu.config as jcfg
import orb_slam2_ros2_tpu_torch.config as tcfg
from orb_slam2_ros2_tpu.solvers import global_ba as jgba
from orb_slam2_ros2_tpu.solvers import pcg_ba as jpcg
from orb_slam2_ros2_tpu_torch import convert
from orb_slam2_ros2_tpu_torch.geometry import camera as tcam
from orb_slam2_ros2_tpu_torch.parallel import ba_mesh
from orb_slam2_ros2_tpu_torch.solvers import global_ba as tgba
from orb_slam2_ros2_tpu_torch.solvers import pcg_ba as tpcg

POSE_M, POSE_DEG, POINT_M, POINT_REL = 1e-4, 1e-3, 1e-3, 2e-4
PCG_ITERS = 20


@pytest.fixture(scope="module")
def world():
    slam, _, record = run_jax_mapping(small_cfg(jcfg))
    cfg_t = small_cfg(tcfg)
    return dict(slam=slam, rec=record, map=slam.map, cam_j=slam.cam,
                cam_t=tcam.CameraParams.from_config(cfg_t.camera, "cpu"),
                sf=cfg_t.orb.scale_factor)


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def assert_tables_equal(t_tree, j_tree, names=None):
    for name, a in convert.to_numpy(t_tree).items():
        if names is None or name in names:
            np.testing.assert_array_equal(a, np.asarray(getattr(j_tree, name)), err_msg=name)


def assert_poses_close(Tt, Tj, pose_m=POSE_M, pose_deg=POSE_DEG):
    Tt, Tj = np.asarray(Tt), np.asarray(Tj)
    assert np.abs(Tt[..., :3, 3] - Tj[..., :3, 3]).max() <= pose_m
    assert rot_deg(Tt, Tj).max() <= pose_deg


def compact_problems(world):
    """The JAX snapshot problem of the final map and its port copy."""
    pj = jgba.start_global_ba(world["map"], world["sf"]).prob
    return pj, convert.global_ba_problem_to_torch(np_tree(pj), "cpu")


# ------------------------------------------------------------ extraction --

def test_extract_global_problem_matches_jax(world):
    pj = jgba.extract_global_problem(world["map"], world["sf"])
    pt = tgba.extract_global_problem(to_torch(world["map"]), world["sf"])
    assert_tables_equal(pt, pj)
    assert int(np.asarray(pj.obs_valid).sum()) > 1000


@pytest.mark.parametrize("n_feat", [None, 16], ids=["sized", "dropping"])
def test_point_to_global_matches_jax(world, n_feat):
    """The camera-major view equals the host numpy one exactly, including
    the edges a too-small feature capacity drops from both views."""
    pp = jgba.extract_global_problem(world["map"], world["sf"])
    gj = jpcg.point_to_global(pp, n_feat=n_feat)
    gt = tpcg.point_to_global(convert.point_ba_problem_to_torch(np_tree(pp), "cpu"), n_feat=n_feat)
    assert_tables_equal(gt, gj)
    pm, cm = np.asarray(gj.pm_valid).sum(), np.asarray(gj.cm_valid).sum()
    assert pm == cm
    if n_feat is not None:
        assert pm < np.asarray(pp.obs_valid).sum()


# ------------------------------------------------------------------ solve --

def test_gn_step_matches_jax(world):
    pj, pt = compact_problems(world)
    cam_j, cam_t = world["cam_j"], world["cam_t"]
    pm_th = jnp.where(pj.pm_right_u > 0, 7.815, 5.991)
    cm_th = jnp.where(pj.cm_right_u > 0, 7.815, 5.991)
    # start from a perturbed iterate so that the step has work to do
    Tj0 = np.asarray(pj.cam_Tcw).copy()
    Tj0[1:6, :3, 3] += 0.02
    Tj, pTj = jax.jit(lambda T, p: jpcg._gn_step(cam_j, pj, T, p, pj.pm_valid, pj.cm_valid, 0.1,
                                                 PCG_ITERS, pm_th, cm_th, None))(Tj0, pj.pt_pos.T)
    pm_th_t, cm_th_t = tpcg._thresholds(pt, 5.991, 7.815)
    Tt, pTt = tpcg._gn_step(cam_t, pt, torch.from_numpy(Tj0), pt.pt_pos.T, pt.pm_valid, pt.cm_valid, 0.1,
                            PCG_ITERS, pm_th_t, cm_th_t)
    assert np.abs(np.asarray(Tj) - Tj0).max() > 1e-3
    assert_poses_close(Tt.numpy(), Tj)
    np.testing.assert_allclose(pTt.numpy(), np.asarray(pTj), atol=POINT_M, rtol=POINT_REL)


def test_solve_global_ba_matches_jax(world):
    pj, pt = compact_problems(world)
    kw = dict(phase_iters=(2, 2), pcg_iters=PCG_ITERS)
    Tj, pj_pos, gj = jax.jit(lambda p: jpcg.solve_global_ba(world["cam_j"], p, **kw))(pj)
    Tt, pt_pos, gt = tpcg.solve_global_ba(world["cam_t"], pt, **kw)
    assert_poses_close(Tt.numpy(), Tj)
    ok = np.asarray(pj.pt_valid)
    np.testing.assert_allclose(pt_pos.numpy()[ok], np.asarray(pj_pos)[ok], atol=POINT_M, rtol=POINT_REL)
    assert (gt.numpy() != np.asarray(gj)).sum() <= 2


def test_global_ba_commits_like_jax(world):
    """The synchronous whole solve, committed onto the map."""
    kw = dict(scale_factor=world["sf"], phase_iters=(1, 1), pcg_iters=PCG_ITERS)
    mj = jgba.global_ba(world["map"], world["cam_j"], **kw)   # host numpy inside: not jittable
    mt = tgba.global_ba(to_torch(world["map"]), world["cam_t"], **kw)
    assert_poses_close(mt.kf_Tcw.numpy(), mj.kf_Tcw)
    np.testing.assert_allclose(mt.mp_pos.numpy(), np.asarray(mj.mp_pos), atol=POINT_M, rtol=POINT_REL)
    # sharded over two CPU slots: the same commit within the same budget
    ms = tgba.global_ba(to_torch(world["map"]), world["cam_t"], mesh=ba_mesh(2, devices=["cpu"] * 2), **kw)
    assert_poses_close(ms.kf_Tcw.numpy(), mj.kf_Tcw)
    np.testing.assert_allclose(ms.mp_pos.numpy(), np.asarray(mj.mp_pos), atol=POINT_M, rtol=POINT_REL)


# ------------------------------------------------------- chunked + commit --

def run_chunks(world, state_j, n_chunks):
    """start + n_chunks steps in both packages: (pending_j, pending_t)."""
    kw = dict(n_iters=1, pcg_iters=PCG_ITERS, robust_after=1)
    pj = jgba.start_global_ba(state_j, world["sf"])
    pt = tgba.start_global_ba(to_torch(state_j), world["sf"])
    assert (pt.snap_next_kf, pt.snap_next_mp) == (pj.snap_next_kf, pj.snap_next_mp)
    assert_tables_equal(pt.prob, pj.prob)
    np.testing.assert_array_equal(pt.pt_in_ba.numpy(), np.asarray(pj.pt_in_ba))
    for _ in range(n_chunks):
        pj = jgba.step_global_ba(pj, world["cam_j"], **kw)
        pt = tgba.step_global_ba(pt, world["cam_t"], **kw)
        assert pt.chunks_done == pj.chunks_done
        assert_poses_close(pt.Tcw.numpy(), pj.Tcw)
        np.testing.assert_allclose(pt.ptsT.numpy(), np.asarray(pj.ptsT), atol=POINT_M, rtol=POINT_REL)
    return pj, pt


def test_start_step_commit_match_jax(world):
    """The background GBA on the final map: snapshot tables equal, the
    iterate after each chunk (ungated, then gated) within tolerance, the
    commit likewise; the snapshot owns its buffers."""
    pj, pt = run_chunks(world, world["map"], 3)
    live = to_torch(world["map"])
    cj = jgba.commit_global_ba(world["map"], pj)
    ct = tgba.commit_global_ba(live, pt)
    assert_poses_close(ct.kf_Tcw.numpy(), cj.kf_Tcw)
    np.testing.assert_allclose(ct.mp_pos.numpy(), np.asarray(cj.mp_pos), atol=POINT_M, rtol=POINT_REL)
    assert pt.prob.cam_Tcw.data_ptr() != live.kf_Tcw.data_ptr()
    # a chunk over two CPU slots from the last iterate: the JAX chunk's
    # result within the same budget
    kw = dict(n_iters=1, pcg_iters=PCG_ITERS, robust_after=1)
    sj = jgba.step_global_ba(pj, world["cam_j"], **kw)
    st = tgba.step_global_ba(pt, world["cam_t"], mesh=ba_mesh(2, devices=["cpu"] * 2), **kw)
    assert st.chunks_done == sj.chunks_done and st.shards is not None
    assert_poses_close(st.Tcw.numpy(), sj.Tcw)
    np.testing.assert_allclose(st.ptsT.numpy(), np.asarray(sj.ptsT), atol=POINT_M, rtol=POINT_REL)


def test_commit_onto_grown_map_matches_jax(world):
    """Snapshot before the last keyframe's insertion, commit after it: the
    keyframe created during the solve follows its spanning-tree parent and
    the new points ride their reference keyframe, as in JAX."""
    before = world["rec"]["pre"][0]
    after = world["map"]
    assert int(after.next_kf) > int(before.next_kf) and int(after.next_mp) > int(before.next_mp)
    pj, pt = run_chunks(world, before, 2)
    cj = jgba.commit_global_ba(after, pj)
    ct = tgba.commit_global_ba(to_torch(after), pt)
    assert_poses_close(ct.kf_Tcw.numpy(), cj.kf_Tcw)
    np.testing.assert_allclose(ct.mp_pos.numpy(), np.asarray(cj.mp_pos), atol=POINT_M, rtol=POINT_REL)
    new_kf = int(before.next_kf)
    moved = np.abs(np.asarray(cj.kf_Tcw)[new_kf] - np.asarray(after.kf_Tcw)[new_kf]).max()
    assert moved > 0, "the post-snapshot keyframe was not propagated"
    # an explicit shallow propagation depth is honoured alike
    cj1 = jgba.commit_global_ba(after, pj, propagate_depth=1)
    ct1 = tgba.commit_global_ba(to_torch(after), pt, propagate_depth=1)
    assert_poses_close(ct1.kf_Tcw.numpy(), cj1.kf_Tcw)
