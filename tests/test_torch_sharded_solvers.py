"""Parity of the port's sharded solvers with the JAX package's, on the CPU:
the JAX side shards over the 8 virtual CPU devices of ``conftest.py``, the
port's mesh has n CPU slots (``ba_mesh(n, devices=["cpu"] * n)``), n = 2
and 8, with sizes n does not divide.

* the edge-sharded pose graph (23 edges): one GN step within 1e-4 and the
  20-iteration solve within 2e-3 of JAX's sharded versions (the budgets of
  ``test_torch_pose_graph.py``), and of the port's unsharded PCG;
* the landmark-sharded global BA (21 cameras, 203 landmarks): the solve and
  one chunk of the background solve (``step_global_ba`` with a mesh,
  ungated and gated) within 1e-4 m / 1e-3° on the cameras and 1 mm + 2e-4
  on the points (``test_torch_global_ba.py``), gates within 2 entries,
  against JAX's sharded solve and chunk program, and against the port's
  unsharded ones;
* a repeated port run is bit-equal to the first.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from test_torch_global_ba import POINT_M, POINT_REL, assert_poses_close
from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)
from test_torch_pose_graph import drift_chain, se3_of, to_t

import orb_slam2_ros2_tpu.config as jcfg
from orb_slam2_ros2_tpu.geometry.camera import CameraParams as JCam
from orb_slam2_ros2_tpu.solvers import global_ba as jgba
from orb_slam2_ros2_tpu.solvers import pcg_ba as jpcg
from orb_slam2_ros2_tpu.solvers import pose_graph as jpg
from orb_slam2_ros2_tpu_torch import convert, entry
from orb_slam2_ros2_tpu_torch.parallel import ba_mesh
from orb_slam2_ros2_tpu_torch.solvers import global_ba as tgba
from orb_slam2_ros2_tpu_torch.solvers import pcg_ba as tpcg
from orb_slam2_ros2_tpu_torch.solvers import pose_graph as tpg

N_SHARDS = [2, 8]
K_PG = 23                 # vertices and edges of the drift chain
C, P = 21, 203            # cameras and landmarks of the corridor
GBA_KW = dict(phase_iters=(2, 2), pcg_iters=10)


def meshes(n):
    return JMesh(np.array(jax.devices()[:n]), ("ba",)), ba_mesh(n, devices=["cpu"] * n)


# ------------------------------------------------------------- pose graph --

@pytest.mark.parametrize("n", N_SHARDS)
def test_sharded_pose_graph_step_matches_jax(n):
    prob, _, _ = drift_chain(K=K_PG)
    jm, tm = meshes(n)
    tp = to_t(prob)
    Sj = jax.jit(jpg._gn_step_pcg_sharded, static_argnums=(2, 3, 4, 5))(prob, prob.S_cw, 1e-6, 150, jm, "ba")
    St = tpg._gn_step_pcg_sharded(tp, tp.S_cw, 1e-6, 150, tm)
    assert np.abs(se3_of(St) - se3_of(prob.S_cw)).max() > 1e-2
    np.testing.assert_allclose(se3_of(St), se3_of(Sj), atol=1e-4)
    np.testing.assert_allclose(se3_of(St), se3_of(tpg._gn_step_pcg(tp, tp.S_cw, 1e-6, 150)), atol=1e-4)


@pytest.mark.parametrize("n", N_SHARDS)
def test_sharded_pose_graph_solve_matches_jax(n):
    """The drift chain solved over the mesh: the JAX sharded solution, the
    port's unsharded PCG solution, the drift spread, vertex 0 fixed, and
    the same bits on a second run."""
    prob, gt, est = drift_chain(K=K_PG)
    jm, tm = meshes(n)
    tp = to_t(prob)
    Sj = jax.jit(lambda p: jpg.optimize_pose_graph(p, iters=20, mesh=jm))(prob)
    St = tpg.optimize_pose_graph(tp, iters=20, mesh=tm)
    Tt = se3_of(St)
    np.testing.assert_allclose(Tt, se3_of(Sj), atol=2e-3)
    np.testing.assert_allclose(Tt, se3_of(tpg.optimize_pose_graph(tp, iters=20, dense_max_k=0)), atol=2e-3)
    assert np.linalg.norm(Tt[-1][:3, 3] - gt[-1][:3, 3]) < 0.35 * np.linalg.norm(est[-1][:3, 3] - gt[-1][:3, 3])
    np.testing.assert_allclose(Tt[0], est[0], atol=1e-5)
    again = tpg.optimize_pose_graph(tp, iters=20, mesh=tm)
    assert all(torch.equal(a, b) for a, b in zip(St, again))


def test_sharded_pose_graph_checks_the_axis():
    prob, _, _ = drift_chain(K=6)
    with pytest.raises(ValueError, match="axis"):
        tpg.optimize_pose_graph(to_t(prob), mesh=ba_mesh(2, devices=["cpu"] * 2), mesh_axis="other")


# -------------------------------------------------------------- global BA --

@pytest.fixture(scope="module")
def corridor():
    """The dry run's corridor problem at a size 2 and 8 do not divide, in
    both packages (the JAX view built on the host, carried to the port)."""
    cam_t, pp = entry.gba_problem(C, P, device="cpu")
    pj = jpcg.point_to_global(jpcg.PointBAProblem(*(jax.numpy.asarray(a.numpy()) for a in pp)))
    pt = convert.global_ba_problem_to_torch(jax.tree.map(np.asarray, pj), "cpu")
    c = entry.DRYRUN_CAMERA
    cam_j = JCam.from_config(jcfg.CameraConfig(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, baseline=c.baseline,
                                               width=c.width, height=c.height))
    return dict(pj=pj, pt=pt, cam_j=cam_j, cam_t=cam_t)


def assert_gba_close(T, pts, Tref, pref, ok):
    assert_poses_close(np.asarray(T), np.asarray(Tref))
    np.testing.assert_allclose(np.asarray(pts)[..., ok], np.asarray(pref)[..., ok], atol=POINT_M, rtol=POINT_REL)


@pytest.mark.parametrize("n", N_SHARDS)
def test_sharded_global_ba_solve_matches_jax(corridor, n):
    pj, pt, cam_j, cam_t = corridor["pj"], corridor["pt"], corridor["cam_j"], corridor["cam_t"]
    jm, tm = meshes(n)
    Tj, pts_j, gj = jpcg.solve_global_ba_sharded(cam_j, pj, jm, **GBA_KW)
    Tt, pts_t, gt = tpcg.solve_global_ba_sharded(cam_t, pt, tm, **GBA_KW)
    Tu, pts_u, gu = tpcg.solve_global_ba(cam_t, pt, **GBA_KW)
    ok = np.asarray(pj.pt_valid)
    assert Tt.shape == (C, 4, 4) and pts_t.shape == (P, 3) and gt.shape == pt.pm_valid.shape
    assert np.abs(pts_t.numpy() - pt.pt_pos.numpy()).max() > 1e-2   # the 5 cm perturbation moved
    assert_gba_close(Tt.numpy(), pts_t.numpy().T, Tj, np.asarray(pts_j).T, ok)
    assert_gba_close(Tt.numpy(), pts_t.numpy().T, Tu.numpy(), pts_u.numpy().T, ok)
    assert (gt.numpy() != np.asarray(gj)).sum() <= 2 and (gt != gu).sum() <= 2
    again = tpcg.solve_global_ba_sharded(cam_t, pt, tm, **GBA_KW)
    assert all(torch.equal(a, b) for a, b in zip((Tt, pts_t, gt), again))


@pytest.mark.parametrize("robust", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("n", N_SHARDS)
def test_sharded_gba_chunk_matches_jax(corridor, n, robust):
    """One chunk of the background solve over the mesh against JAX's
    sharded chunk program on the padded problem (JAX's ``step_global_ba``
    hands it the unpadded camera iterate, which a camera count the mesh
    does not divide would misalign; the system's snapshots round it to 64),
    and against the port's unsharded chunk; the shards are made once and
    kept in the pending solve."""
    pj, pt, cam_j, cam_t = corridor["pj"], corridor["pt"], corridor["cam_j"], corridor["cam_t"]
    jm, tm = meshes(n)
    pad = jpcg._pad_global(pj, n)
    fn = jgba._sharded_step_jit(jm, "ba", 1, 10, 0.1, 5.991, 7.815, robust)
    Tj, pts_j = fn(cam_j, pad, pad.cam_Tcw, pad.pt_pos.T)
    pend = tgba.PendingGBA(prob=pt, Tcw=pt.cam_Tcw, ptsT=pt.pt_pos.T.contiguous(), pt_in_ba=pt.pt_valid,
                           snap_next_kf=C, snap_next_mp=P, chunks_done=int(robust))
    kw = dict(n_iters=1, pcg_iters=10, robust_after=1)
    st = tgba.step_global_ba(pend, cam_t, mesh=tm, **kw)
    su = tgba.step_global_ba(pend, cam_t, **kw)
    ok = np.asarray(pj.pt_valid)
    assert st.chunks_done == pend.chunks_done + 1 and st.shards[0] is tm
    assert st.Tcw.shape == (C, 4, 4) and st.ptsT.shape == (3, P)
    assert_gba_close(st.Tcw.numpy(), st.ptsT.numpy(), np.asarray(Tj)[:C], np.asarray(pts_j)[:, :P], ok)
    assert_gba_close(st.Tcw.numpy(), st.ptsT.numpy(), su.Tcw.numpy(), su.ptsT.numpy(), ok)
    # the next chunk reuses the shards
    st2 = tgba.step_global_ba(st, cam_t, mesh=tm, **kw)
    assert st2.shards is st.shards
    again = tgba.step_global_ba(pend, cam_t, mesh=tm, **kw)
    assert torch.equal(again.Tcw, st.Tcw) and torch.equal(again.ptsT, st.ptsT)
