"""The multi-device routes' graph wrappers on the CPU, against the JAX
package and the port's eager programs: the sharded background-GBA chunk
through ``global_ba.GBAGraphs``, the sharded essential graph through
``loop_closing.EssentialGraph`` and the split's per-frame bookkeeping
through ``frame_graph.KeyframeGraphs.bookkeep`` (JAX's ``_sharded_step_jit``,
``_essential_mesh`` and ``_bookkeep_d1``).

The mesh is two CPU slots of this process (``ba_mesh(2, devices=["cpu"] *
2)``), the layout ``Mesh.capturable`` admits; the JAX side shards over 2 of
``conftest.py``'s 8 virtual CPU devices.  ``capture=False`` runs the CUDA
path's static-buffer wrappers with each program called where the card
replays its graph.

* ``Mesh.capturable`` on the three layouts: one process on one device
  (yes), one process over two devices and two processes (no).  ``"cpu"``
  and ``"cpu:0"`` are two devices to the rule and one to the CPU, so the
  eager route of a mesh over several devices runs here.
* The bucketed sharded chunk, ungated and gated through one wrapper,
  within ``test_torch_sharded_solvers.py``'s budgets of JAX's
  ``_sharded_step_jit`` and of the port's eager ``step_global_ba`` over the
  mesh (1e-4 m / 1e-3° on the cameras, 1 mm + 2e-4 on the points), and bit
  for bit ``global_ba_phase`` with a Python gate on the bucket's problem
  sharded over the mesh; a second call equals the first, and a second
  snapshot of the bucket equals its own eager run.  Over a mesh of two
  devices the system's chunk is ``step_global_ba`` itself, eagerly.
* The sharded essential graph within ``test_torch_essential_graph.py``'s
  budget of JAX's ``optimize_essential`` with the edge-sharded pose graph
  (integer tables exact, poses 1 mm, points 5 mm) and bit for bit the
  port's eager ``LoopCloser._essential_mesh``; a second closure through
  the same wrapper equals its own eager run; over a mesh of two devices
  the step runs eagerly between the two wrapped parts, bit for bit the
  same.
* The bookkeeping wrapper equal to the JAX functions ``_bookkeep_program``
  composes (``bump_tracking_counters``, ``_bookkeep_stats``,
  ``local_map_snapshot_frame``) on the same converted map, and bit for bit
  the eager ``SLAM.bookkeep_program``, the storage's counters included; a
  second call with another reference keyframe equals its own eager run.
* Each new program runs under ``torch_host_reads.NoHostReads``.

On the card (``gpu``, skipped here) each replay equals its eager wrapper.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from test_torch_essential_graph import assert_bit_equal, corrected, t32  # noqa: F401  (corrected a fixture)
from test_torch_loop_closing import assert_maps_agree, np_tree, ring  # noqa: F401  (ring a fixture)
from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)
from test_torch_sharded_solvers import assert_gba_close, corridor  # noqa: F401  (corridor a fixture)
from torch_host_reads import NoHostReads

from orb_slam2_ros2_tpu.mapstate import local_map as jlm
from orb_slam2_ros2_tpu.pipeline import loop_closing as jlc
from orb_slam2_ros2_tpu.pipeline import system as jsys
from orb_slam2_ros2_tpu.solvers import global_ba as jgba
from orb_slam2_ros2_tpu.solvers import pcg_ba as jpcg
from orb_slam2_ros2_tpu.solvers.pose_graph import optimize_pose_graph as j_opg
from orb_slam2_ros2_tpu_torch import convert
from orb_slam2_ros2_tpu_torch.geometry import sim3 as tsim3
from orb_slam2_ros2_tpu_torch.mapstate.map_state import MapState
from orb_slam2_ros2_tpu_torch.parallel import ba_mesh
from orb_slam2_ros2_tpu_torch.parallel.mesh import Mesh
from orb_slam2_ros2_tpu_torch.pipeline import loop_closing as tlc
from orb_slam2_ros2_tpu_torch.pipeline import system as tsys
from orb_slam2_ros2_tpu_torch.solvers import global_ba as tgba
from orb_slam2_ros2_tpu_torch.solvers import pcg_ba as tpcg

N_SHARDS = 2
PCG_ITERS = 10            # test_torch_sharded_solvers.py's chunk
ROBUST_AFTER = 1
CAPACITY = (64, 512)      # the bucket (32 cameras, 256 points) pads the corridor's 21 and 203
SOLVER = dict(n_iters=1, pcg_iters=PCG_ITERS, lam=0.1, chi2_mono=5.991, chi2_stereo=7.815)
TWO_DEVICES = ["cpu", "cpu:0"]   # one process over two devices: not capturable


def mesh(devices=None):
    return ba_mesh(N_SHARDS, devices=devices or ["cpu"] * N_SHARDS)


def clone_map(m) -> MapState:
    return MapState(*(t.clone() for t in m))


def test_capture_rule_follows_the_layout():
    one = mesh()
    assert one.capturable and not one.multi_process
    two_devices = mesh(TWO_DEVICES)
    assert len(two_devices.local_devices) == 2 and not two_devices.capturable
    gpus = Mesh(axis="ba", slots=((0, torch.device("cuda", 0)), (0, torch.device("cuda", 1))))
    assert not gpus.capturable
    same_gpu = Mesh(axis="ba", slots=((0, torch.device("cuda", 0)), (0, torch.device("cuda", 0))))
    assert same_gpu.capturable
    ranks = Mesh(axis="ba", slots=((0, torch.device("cpu")), (1, torch.device("cpu"))), rank=0)
    assert ranks.multi_process and not ranks.capturable


# ------------------------------------------------------------ GBA chunk --

def pending(corridor, chunks_done=0, moved=False):
    pt = corridor["pt"]
    if moved:
        pt = pt._replace(cam_Tcw=pt.cam_Tcw.clone(), pt_pos=pt.pt_pos + 0.01)
        pt.cam_Tcw[1:, :3, 3] += 0.02
    return tgba.PendingGBA(prob=pt, Tcw=pt.cam_Tcw, ptsT=pt.pt_pos.T.contiguous(), pt_in_ba=pt.pt_valid,
                           snap_next_kf=pt.cam_Tcw.shape[0], snap_next_mp=pt.pt_pos.shape[0],
                           chunks_done=chunks_done)


def eager_chunk(corridor, pend, tm):
    """``global_ba_phase`` with a Python gate over the mesh, on the bucket's
    problem sharded over it: (Tcw, ptsT) cut back to the snapshot's shapes."""
    K, M, N = tgba.GBAGraphs.bucket(pend, CAPACITY)
    K0, M0 = pend.Tcw.shape[0], pend.ptsT.shape[1]
    shards = tpcg._shard_global(tpcg.pad_global_to(pend.prob, K, M, N), tm)
    Tcw = torch.cat([pend.Tcw, torch.eye(4).expand(K - K0, 4, 4)])
    ptsT = torch.cat([pend.ptsT, torch.zeros(3, M - M0)], dim=1)
    Tcw, ptsT = tpcg.global_ba_phase(corridor["cam_t"], shards, Tcw, tm.split(ptsT), axis=tm,
                                     robust_gate=pend.chunks_done >= ROBUST_AFTER, **SOLVER)
    return Tcw[:K0], tm.all_gather(ptsT)[:, :M0]


def test_sharded_chunks_match_jax_the_eager_chunk_and_the_program(corridor):
    pj, pt, cam_j, cam_t = corridor["pj"], corridor["pt"], corridor["cam_j"], corridor["cam_t"]
    tm = mesh()
    jm = JMesh(np.array(jax.devices()[:N_SHARDS]), ("ba",))
    pad = jpcg._pad_global(pj, N_SHARDS)
    ok = np.asarray(pj.pt_valid)
    K, M, N = tgba.GBAGraphs.bucket(pending(corridor), CAPACITY)
    K0, M0 = pt.cam_Tcw.shape[0], pt.pt_pos.shape[0]
    assert (K, M) == (32, 256) and N >= pt.cm_pt.shape[0]
    g = tgba.GBAGraphs(n_iters=1, pcg_iters=PCG_ITERS, capture=False)
    for done in (0, 1):   # ungated, gated: one wrapper
        pend = pending(corridor, done)
        with NoHostReads() as mode:
            out = g.step(pend, cam_t, robust_after=ROBUST_AFTER, capacity=CAPACITY, mesh=tm)
        assert mode.ops > 1000 and out.chunks_done == done + 1
        assert out.Tcw.shape == pend.Tcw.shape and out.ptsT.shape == pend.ptsT.shape
        Tj, pts_j = jgba._sharded_step_jit(jm, "ba", 1, PCG_ITERS, 0.1, 5.991, 7.815, bool(done))(
            cam_j, pad, pad.cam_Tcw, pad.pt_pos.T)
        assert_gba_close(out.Tcw.numpy(), out.ptsT.numpy(), np.asarray(Tj)[:K0], np.asarray(pts_j)[:, :M0], ok)
        plain = tgba.step_global_ba(pend, cam_t, mesh=tm, robust_after=ROBUST_AFTER, n_iters=1, pcg_iters=PCG_ITERS)
        assert_gba_close(out.Tcw.numpy(), out.ptsT.numpy(), plain.Tcw.numpy(), plain.ptsT.numpy(), ok)
        want = eager_chunk(corridor, pend, tm)
        assert torch.equal(out.Tcw, want[0]) and torch.equal(out.ptsT, want[1])
        again = g.step(pend, cam_t, robust_after=ROBUST_AFTER, capacity=CAPACITY, mesh=tm)
        assert torch.equal(again.Tcw, out.Tcw) and torch.equal(again.ptsT, out.ptsT)
    assert g.captures == 1 and g.capture_log == [("chunk", (K, M, N, pt.pm_cam.shape[0]), N_SHARDS)]
    assert g.chunk_replays == 4 and g.snapshot_loads == 1
    # the bucket's static problem is sharded into views of itself
    b = g._bucket
    assert all(s.pm_uv.untyped_storage().data_ptr() == b.prob.pm_uv.untyped_storage().data_ptr()
               for s in b.shards)


def test_second_snapshot_of_a_sharded_bucket_equals_its_own_eager_run(corridor):
    """A snapshot with moved poses and points (the same bucket) is copied
    into the static problem and reaches the chunk through the shards."""
    tm = mesh()
    g = tgba.GBAGraphs(n_iters=1, pcg_iters=PCG_ITERS, capture=False)
    outs = []
    for moved in (False, True, False):
        pend = pending(corridor, 1, moved)
        with NoHostReads():
            out = g.step(pend, corridor["cam_t"], robust_after=ROBUST_AFTER, capacity=CAPACITY, mesh=tm)
        want = eager_chunk(corridor, pend, tm)
        assert torch.equal(out.Tcw, want[0]) and torch.equal(out.ptsT, want[1])
        outs.append(out)
    assert not torch.equal(outs[0].Tcw, outs[1].Tcw)
    assert g.captures == 1 and g.snapshot_loads == 3


def test_chunk_over_a_mesh_of_two_devices_stays_eager(monkeypatch):
    """Over a mesh ``Mesh.capturable`` refuses, ``GBAGraphs.step`` (the
    system's chunk) runs ``step_global_ba`` eagerly; the commit goes
    through the commit graph, as under any mesh."""
    from test_torch_split_mode import split_cfg

    cfg = split_cfg(False, n_devices=2)
    slam = tsys.SLAM(cfg, device="cpu", devices=TWO_DEVICES)
    assert slam.mesh is not None and not slam.mesh.capturable
    pend = tgba.start_global_ba(slam.map, cfg.orb.scale_factor)
    calls = []
    step = tgba.step_global_ba

    def spy(pending, cam, **kw):
        calls.append(kw.get("mesh"))
        return step(pending, cam, **kw)

    monkeypatch.setattr(tgba, "step_global_ba", spy)
    out = slam._gba_chunk(pend)
    assert calls == [slam.mesh] and out.chunks_done == 1
    g = slam._gba_graphs
    assert g.eager_chunks == 1 and g.chunk_replays == 0 and g.captures == 0
    b = cfg.ba
    want = step(pend, slam.map_cam, n_iters=1, pcg_iters=b.pcg_iters, chi2_mono=b.chi2_mono,
                chi2_stereo=b.chi2_stereo, robust_after=cfg.loop.global_ba_phase_iters[0],
                mesh=slam.mesh, axis=cfg.dist.mesh_axis)
    assert torch.equal(out.Tcw, want.Tcw) and torch.equal(out.ptsT, want.ptsT)
    slam._pending_gba = out
    slam._commit_pending_gba()
    assert g.commit_replays == 1


# -------------------------------------------------------- essential graph --

def test_sharded_essential_graph_matches_jax_and_the_eager_mesh_route(ring, corrected):
    s2j, S12j, S_ncj, gmask_j, pre_j = corrected["j_in"]
    jm = JMesh(np.array(jax.devices()[:N_SHARDS]), ("ba",))
    ej = jax.jit(partial(jlc.optimize_essential, essential_weight=100,
                         pose_graph_fn=partial(j_opg, iters=20, mesh=jm, mesh_axis="ba")))(
        s2j, 11, 0, S12j, S_ncj, gmask_j, pre_j)
    state, S12, S_nc, gmask, pre = corrected["t_in"]
    tm = mesh()
    lc = tlc.LoopCloser(ring["cfg_t"], ring["ct"].vocab)
    g = tlc.EssentialGraph(essential_weight=100, mesh=tm, capture=False)
    ids = t32(11), t32(0)
    with NoHostReads():
        et = g(state, *ids, S12, S_nc, gmask, pre)
    assert_maps_agree(ej, et, point_m=5e-3, pose_m=1e-3)
    assert_bit_equal(et, lc._essential_mesh(state, *ids, S12, S_nc, gmask, pre, mesh=tm))
    assert g.captures == 3 and g.parts[1].replays == 20

    # another closure (pair and Sim3) through the same statics
    S12b = tsim3.Sim3(R=S12.R, t=S12.t + 0.05, s=S12.s * 1.01)
    ids2 = t32(10), t32(1)
    with NoHostReads():
        et2 = g(state, *ids2, S12b, S_nc, gmask, pre)
    assert_bit_equal(et2, lc._essential_mesh(state, *ids2, S12b, S_nc, gmask, pre, mesh=tm))
    assert not torch.equal(et2.kf_Tcw, et.kf_Tcw)
    assert g.captures == 3 and g.replays == 2 * 22

    # over two devices the sharded step runs eagerly between the wrapped parts
    two = tlc.EssentialGraph(essential_weight=100, mesh=mesh(TWO_DEVICES), capture=False)
    assert_bit_equal(two(state, *ids, S12, S_nc, gmask, pre), et)
    assert two.parts[1].replays == 0 and two.parts[0].replays == two.parts[2].replays == 1


def test_loop_closer_keys_the_essential_graph_on_the_mesh(ring):
    """``warm_essential`` with a mesh builds the mesh's graph, which a
    closure over that mesh reuses; another mesh (or none) builds its own."""
    lc = tlc.LoopCloser(ring["cfg_t"], ring["ct"].vocab)
    tm = mesh()
    lc.warm_essential(ring["stt"], tm)
    g = lc.essential
    assert g.mesh is tm and g.captures == 3
    assert lc._essential_graph(torch.device("cpu"), mesh()) is g          # an equal mesh
    assert lc._essential_graph(torch.device("cpu")).mesh is None
    assert lc._essential_graph(torch.device("cpu"), tm) is not g
    with pytest.raises(ValueError, match="axis"):
        lc._essential_graph(torch.device("cpu"), ba_mesh(2, axis="other", devices=["cpu"] * 2))


# ------------------------------------------------------------ bookkeeping --

def bookkeep_inputs(ring, kf: int, seed: int):
    """A frame's bookkeeping inputs in both packages: keyframe ``kf``'s
    local map and points as the frame's, visible / found drawn from a seed."""
    cfg = ring["cfg_j"]
    t = cfg.tracking
    local_j = jlm.local_map_snapshot(ring["sj"], kf, max_kfs=t.max_local_keyframes, max_mps=t.max_local_mappoints)
    mp_ids_j = ring["sj"].kf_mp_idx[kf]
    rng = np.random.default_rng(seed)
    visible = rng.random(local_j.mp_ids.shape[0]) < 0.7
    found = visible & (rng.random(visible.shape[0]) < 0.6)
    j_in = (local_j, mp_ids_j, jnp.asarray(visible), jnp.asarray(found))
    t_in = (convert.local_map_to_torch(np_tree(local_j), "cpu"), torch.from_numpy(np.asarray(mp_ids_j)),
            torch.from_numpy(visible), torch.from_numpy(found))
    return j_in, t_in


def jax_bookkeep(ring, sj, local, mp_ids, visible, found, ref_kf):
    t = ring["cfg_j"].tracking
    m2 = jlm.bump_tracking_counters(sj, local, visible, found)
    hv1 = jsys._bookkeep_stats(m2, mp_ids, jnp.asarray(ref_kf), min_obs_bar=t.n_ref_min_obs)
    local2 = jlm.local_map_snapshot_frame(m2, mp_ids, max_kfs=t.max_local_keyframes, max_mps=t.max_local_mappoints)
    return m2, hv1, local2


def test_bookkeeping_wrapper_matches_jax_and_the_eager_program(ring):
    slam = tsys.SLAM(ring["cfg_t"], device="cpu")
    storage = clone_map(ring["stt"])
    eager_map = clone_map(ring["stt"])
    sj = ring["sj"]
    for kf, ref_kf, seed in ((11, 11, 0), (5, 4, 1)):   # the second: another frame and reference keyframe
        j_in, t_in = bookkeep_inputs(ring, kf, seed)
        sj, hv_j, local_j = jax_bookkeep(ring, sj, *j_in, ref_kf)
        with NoHostReads():
            hv, local = slam._kf_graphs.bookkeep(storage, *t_in, ref_kf)
        np.testing.assert_array_equal(hv.numpy(), np.asarray(hv_j))
        for name, a in zip(local._fields, local):
            b = np.asarray(getattr(local_j, name))
            np.testing.assert_array_equal(a.numpy(), b.view(np.int32) if b.dtype == np.uint32 else b, err_msg=name)
        for name in ("mp_visible", "mp_found"):
            np.testing.assert_array_equal(getattr(storage, name).numpy(), np.asarray(getattr(sj, name)),
                                          err_msg=name)
        eager_map, hv_e, local_e = slam.bookkeep_program(eager_map, *t_in, torch.tensor([ref_kf]))
        assert torch.equal(hv, hv_e) and all(torch.equal(a, b) for a, b in zip(local, local_e))
        assert all(torch.equal(a, b) for a, b in zip(storage, eager_map))
    assert not torch.equal(storage.mp_visible, ring["stt"].mp_visible)
    assert slam._kf_graphs.captures == 1 and slam._kf_graphs.replays == 2


# ------------------------------------------------------------ on the card --

@pytest.mark.gpu
def test_mesh_and_split_replays_equal_the_eager_wrappers_on_gpu(ring, corridor, corrected):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sharded chunk, the sharded essential graph and the "
                    "bookkeeping are captured there (run python3 chip_smoke.py on the card)")
    from orb_slam2_ros2_tpu_torch.geometry.camera import CameraParams
    from orb_slam2_ros2_tpu_torch.pipeline.frame_graph import KeyframeGraphs, tree_leaves, tree_map

    dev = torch.device("cuda")
    tm = mesh(["cuda:0"] * N_SHARDS)
    cam = CameraParams(*(t.to(dev) for t in corridor["cam_t"]))
    pend = tree_map(lambda t: t.to(dev), pending(corridor))
    state, S12, S_nc, gmask, pre = tree_map(lambda t: t.to(dev), corrected["t_in"])
    j_in, t_in = bookkeep_inputs(ring, 11, 0)
    t_in = tree_map(lambda t: t.to(dev), t_in)
    s = tsys.SLAM(ring["cfg_t"], device="cuda")
    runs = []
    for capture in (False, True):
        g = tgba.GBAGraphs(n_iters=1, pcg_iters=PCG_ITERS, capture=capture)
        e = tlc.EssentialGraph(essential_weight=100, mesh=tm, capture=capture)
        kg = KeyframeGraphs(s.map_front_program, s.map_tail_program, s._cull_kfs, s.bookkeep_program,
                            capture=capture)
        storage = tree_map(lambda t: t.to(dev), clone_map(ring["stt"]))
        out = []
        for done in (0, 1, 1):   # the first captures, then replays (ungated, gated)
            p = g.step(pend._replace(chunks_done=done), cam, robust_after=ROBUST_AFTER, capacity=CAPACITY, mesh=tm)
            out.append((p.Tcw, p.ptsT))
        for _ in range(2):
            ess = e(state, 11, 0, S12, S_nc, gmask, pre)
            out.append((ess.kf_Tcw, ess.mp_pos))
        for _ in range(2):
            out.append(kg.bookkeep(storage, *t_in, 11))
        runs.append((out, storage))
    for a, b in zip(runs[0][0], runs[1][0]):
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
