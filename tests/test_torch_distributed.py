"""Multi-device operation of the port through its entry points, on the CPU.

* The global BA through the SLAM system with ``dist.n_devices=2`` (mesh
  slots ``["cpu"] * 2``), the counterpart of
  ``tests/test_distributed_e2e.py`` (``slow`` in JAX) reached the cheap way:
  the revisit world of ``test_torch_loop_slice.py`` walked from detection to
  the committed GBA.  The two CPU slots are one process on one device, a
  mesh that ``Mesh.capturable`` admits, so the work rides the graph
  wrappers (run eagerly here, ``capture=False``; on the card they replay):
  the essential graph's 20 sharded GN steps run through its step part
  and every background-GBA chunk through ``global_ba.GBAGraphs`` with the
  SLAM's mesh, none eagerly outside them, and the commit through the GBA
  commit graph, as without a mesh.  The committed map matches the same
  walk without a mesh within the loop slice's tolerances (keyframes 1e-3 m
  / 5e-3°, points 5e-3 m): the unsharded system solves the 16-keyframe
  essential graph by the dense Cholesky, the sharded one by the PCG.
* A ``SLAM`` with ``n_devices=2`` maps a synthetic sequence.
* ``entry.dryrun_multichip(2)`` over two CPU slots, and ``(1)`` over one.
* No quiet CPU default: without a card ``local_devices()``,
  ``device_count()``, ``ba_mesh()`` and ``dryrun_multichip()`` raise unless
  given their devices, and run on named CPU slots as before.
* Two processes joined over gloo through ``init_distributed`` and the
  ``SLAM_*`` variables (``entry.run_ranks``, ``torch.multiprocessing``
  spawn) solve the dry run's pose graph and global BA, one shard each; each
  rank's result is bit-equal to the one-process two-shard mesh's.
"""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_loop_closing import assert_maps_agree
from test_torch_loop_slice import KF_CAND, KF_CUR, POINT_M, POSE_DEG, POSE_M, setup_slams
from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)

from orb_slam2_ros2_tpu_torch import entry
from orb_slam2_ros2_tpu_torch.io.synthetic import SyntheticStereoDataset
from orb_slam2_ros2_tpu_torch.parallel import ba_mesh
from orb_slam2_ros2_tpu_torch.pipeline import system as tsys
from orb_slam2_ros2_tpu_torch.solvers import global_ba as tgba
from orb_slam2_ros2_tpu_torch.solvers import pose_graph as tpg

MESH_SLOTS = ["cpu", "cpu"]


def walk(ts):
    """Detection → the three cascade stages → the closure → every GBA
    chunk (the last commits)."""
    ts._dispatch_loop_detect(KF_CUR)
    ts._resolve_pending_loop()
    for _ in range(3):
        ts._step_pending_sim3()
    assert ts.loops_closed == 1 and ts.map.loop_edges[0].tolist() == [KF_CUR, KF_CAND]
    for _ in range(sum(ts.cfg.loop.global_ba_phase_iters)):
        ts._step_pending_gba()
    assert ts._pending_gba is None


def test_gba_through_the_system_rides_the_mesh(monkeypatch):
    """The port's half of the loop slice's walk, once with ``n_devices=2``
    (every sharded call and every graph wrapper spied) and once without."""
    _, plain = setup_slams()
    _, sharded = setup_slams()
    cfg = sharded.cfg.replace(dist=dataclasses.replace(sharded.cfg.dist, n_devices=2))
    probe = tsys.SLAM(cfg, device="cpu", devices=MESH_SLOTS)
    assert probe.mesh is not None and probe.mesh.size == 2 and probe.mesh.local_devices == [torch.device("cpu")] * 2
    assert probe.mesh.capturable
    sharded.cfg, sharded.mesh = cfg, probe.mesh
    n_chunks = sum(cfg.loop.global_ba_phase_iters)

    chunks, graphs, phases, graph_chunks, commits = [], [], [], [], []
    step = tgba.step_global_ba

    def spy_step(pending, cam, **kw):
        chunks.append(kw.get("mesh"))
        return step(pending, cam, **kw)

    sharded_pcg = tpg._gn_step_pcg_sharded

    def spy_pcg(prob, S, damping, cg_iters, mesh, shards=None):
        graphs.append(mesh)
        return sharded_pcg(prob, S, damping, cg_iters, mesh, shards)

    phase = tgba.global_ba_phase

    def spy_phase(*a, axis=None, **kw):
        phases.append(axis)
        return phase(*a, axis=axis, **kw)

    graph_step, graph_commit = tgba.GBAGraphs.step, tgba.GBAGraphs.commit

    def spy_graph_step(graphs_, pending, cam, **kw):
        graph_chunks.append((pending.chunks_done, kw.get("mesh")))
        return graph_step(graphs_, pending, cam, **kw)

    def spy_graph_commit(graphs_, *a, **kw):
        commits.append(graphs_)
        return graph_commit(graphs_, *a, **kw)

    monkeypatch.setattr(tgba, "step_global_ba", spy_step)
    monkeypatch.setattr(tpg, "_gn_step_pcg_sharded", spy_pcg)
    monkeypatch.setattr(tgba, "global_ba_phase", spy_phase)
    monkeypatch.setattr(tgba.GBAGraphs, "step", spy_graph_step)
    monkeypatch.setattr(tgba.GBAGraphs, "commit", spy_graph_commit)
    ess_replays = sharded.loop_closer.essential.parts[1].replays if sharded.loop_closer.essential else 0
    chunk_replays = sharded._gba_graphs.chunk_replays
    walk(sharded)
    # the sharded work, each call of it inside a graph wrapper: 20 GN steps
    # through the essential graph's step part, every chunk through the GBA
    # graphs over the SLAM's mesh, no chunk eagerly outside them
    ess = sharded.loop_closer.essential
    assert ess.mesh is sharded.mesh and ess.parts[1].replays - ess_replays == 20
    assert len(graphs) == 20 and all(m is sharded.mesh for m in graphs)
    assert not chunks and graph_chunks == [(k, sharded.mesh) for k in range(n_chunks)]
    assert sharded._gba_graphs.chunk_replays - chunk_replays == n_chunks
    assert len(phases) == n_chunks and all(m is sharded.mesh for m in phases)
    assert commits == [sharded._gba_graphs]
    graph_chunks.clear()
    walk(plain)
    # without a mesh every chunk runs through the GBA graphs unsharded, none eagerly
    assert not chunks and graph_chunks == [(k, None) for k in range(n_chunks)]
    assert plain.loop_closer.essential.mesh is None
    assert_maps_agree(plain.map, sharded.map, point_m=POINT_M, pose_m=POSE_M, pose_deg=POSE_DEG)
    np.testing.assert_allclose(sharded.last.Tcw.numpy(), plain.last.Tcw.numpy(), atol=POSE_M)


def test_slam_with_two_devices_maps_a_sequence():
    """``SLAM(cfg)`` with ``dist.n_devices=2`` over two CPU slots tracks
    and maps the split test's world frame for frame as without a mesh (no
    loop closes there: the mesh is built and carried)."""
    from test_torch_split_mode import split_cfg

    cfg = split_cfg(False, n_devices=2)
    ds = SyntheticStereoDataset(cfg.camera, n_frames=6, speed=0.55, device="cpu")
    slam = tsys.SLAM(cfg, device="cpu", devices=MESH_SLOTS)
    plain = tsys.SLAM(split_cfg(False), device="cpu")
    assert slam.mesh.size == 2 and plain.mesh is None
    for i in range(6):
        img_l, img_r, _ = ds.frame(i)
        pose, stats = slam.track(img_l, img_r)
        assert pose is not None, (i, stats)
        np.testing.assert_array_equal(pose, plain.track(img_l, img_r)[0])
    slam.flush()
    assert slam.n_keyframes >= 2


def test_two_gloo_ranks_match_the_one_process_mesh(tmp_path):
    C, P, K = 24, 203, 37
    ranks = entry.run_ranks(2, "cpu", C, P, K, str(tmp_path), timeout=240, threads=2)
    ref = entry.sharded_solves(ba_mesh(2, devices=MESH_SLOTS), C, P, K, "cpu")
    assert np.abs(ref["pts"].numpy() - entry.gba_problem(C, P, device="cpu")[1].pt_pos.numpy()).max() > 1e-2
    for rank, res in enumerate(ranks):
        for name, want in ref.items():
            assert torch.equal(res[name], want), (rank, name)


def test_dryrun_multichip_2(capsys):
    """``entry.dryrun_multichip(2)`` over two CPU slots, the counterpart of
    ``tests/test_graft_entry.py::test_dryrun_multichip_2``: the three
    ``dryrun i/3`` lines, the sharded solves within the one-shard solves'
    tolerances of ``test_torch_sharded_solvers.py``, the split on both
    slots."""
    out = entry.dryrun_multichip(2, devices=MESH_SLOTS)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("dryrun")]
    assert [ln[:11] for ln in lines] == ["dryrun 1/3:", "dryrun 2/3:", "dryrun 3/3:"]
    assert out["gba_pose_diff_m"] <= 1e-4 and out["gba_rot_diff_deg"] <= 1e-3
    assert out["gba_point_excess_m"] <= 0 and out["gba_gate_diff"] <= 2 and out["pg_diff"] <= 2e-3
    assert out["split_keyframes"] >= 2 and out["gba_ms"] > 0 and out["pg_ms"] > 0


# ------------------------------------------------- no quiet CPU default --

def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_mesh_helpers_need_devices_without_a_card(monkeypatch):
    """Without a card, ``local_devices()``, ``device_count()`` and
    ``ba_mesh(2)`` raise unless the caller names its slots; named CPU slots
    run as before, and a CPU ``SLAM`` still spreads over CPU slots
    (``default_devices``: the caller asked for the CPU)."""
    from test_torch_split_mode import split_cfg

    from orb_slam2_ros2_tpu_torch.parallel import mesh as tmesh

    _no_card(monkeypatch)
    for call in (tmesh.local_devices, tmesh.device_count, lambda: ba_mesh(2), lambda: ba_mesh(1)):
        with pytest.raises(RuntimeError, match=r'devices=\["cpu"'):
            call()
    assert tmesh.local_devices(["cpu"] * 2) == [torch.device("cpu")] * 2
    assert tmesh.device_count(["cpu"] * 3) == 3
    m = ba_mesh(2, devices=MESH_SLOTS)
    assert m.size == 2 and m.device == torch.device("cpu")
    assert tmesh.default_devices("cpu", 2) == [torch.device("cpu")] * 2
    slam = tsys.SLAM(split_cfg(False, n_devices=2), device="cpu")
    assert slam.mesh.size == 2 and slam.mesh.device == torch.device("cpu")


@pytest.mark.parametrize("n", [1, 2])
def test_dryrun_multichip_needs_devices_without_a_card(monkeypatch, n):
    """``dryrun_multichip(n)`` runs on the visible cards and raises without
    one, ``n = 1`` too (it ran on the CPU before)."""
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match=r'devices=\["cpu"'):
        entry.dryrun_multichip(n)


def test_dryrun_multichip_1(capsys):
    """``entry.dryrun_multichip(1)`` on one CPU slot, what JAX's entry calls
    on a one-chip machine: the sharded solves over a mesh of one device
    (JAX's ``Mesh(devs[:1])``) equal the one-shard solves, and no split
    runs."""
    out = entry.dryrun_multichip(1, devices=["cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("dryrun")]
    assert [ln[:11] for ln in lines] == ["dryrun 1/3:", "dryrun 2/3:"]
    assert out["device"] == "cpu" and "split_keyframes" not in out
    assert out["gba_pose_diff_m"] == 0 and out["gba_gate_diff"] == 0 and out["pg_diff"] == 0
