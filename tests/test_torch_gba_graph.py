"""The background GBA's chunk and commit through ``global_ba.GBAGraphs``, on
the CPU, against the JAX package's ``step_global_ba`` / ``commit_global_ba``
and the port's eager programs, on the map the JAX ``SLAM`` builds in mapping
mode (the ``world`` of ``tests/test_torch_global_ba.py``).

``GBAGraphs(capture=False)`` runs the CUDA path's static-buffer wrappers
with each program called where the card replays its graph:

* the chunk and the commit run under ``torch_host_reads.NoHostReads``;
* the bucketed, padded chunk equals JAX's within ``test_torch_global_ba``'s
  tolerances, and the port's unbucketed eager chunk within 1e-5 m and 1e-4°
  on poses and 1e-4 m + 1e-5 of the coordinate on points (f32 sums over the
  padded axes);
* the ungated and the gated chunks go through one graph (the gate a bool
  [1]) and each equals ``global_ba_phase`` with a Python gate on the padded
  problem bit for bit;
* two snapshots of one bucket, run in turn, each equal their own eager run
  (the second is copied into the bucket's statics);
* the commit onto a map grown after the snapshot, at a propagation depth
  that is not a power of two, equals JAX's (the untouched fields exactly)
  and the eager ``commit_global_ba`` bit for bit.

On the card (``gpu``, skipped here) each replay equals the eager wrapper.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_global_ba import (  # noqa: F401  (two_torch_threads is autouse, world a fixture)
    POINT_M,
    POINT_REL,
    PCG_ITERS,
    assert_poses_close,
    to_torch,
    two_torch_threads,
    world,
)
from torch_host_reads import NoHostReads

from orb_slam2_ros2_tpu.solvers import global_ba as jgba
from orb_slam2_ros2_tpu_torch import convert
from orb_slam2_ros2_tpu_torch.mapstate.map_state import MapState
from orb_slam2_ros2_tpu_torch.solvers import global_ba as tgba
from orb_slam2_ros2_tpu_torch.solvers import pcg_ba as tpcg

ROBUST_AFTER = 1
UNBUCKETED_POSE_M, UNBUCKETED_POSE_DEG = 1e-5, 1e-4
UNBUCKETED_POINT_M, UNBUCKETED_POINT_REL = 1e-4, 1e-5


def graphs(capture=False) -> tgba.GBAGraphs:
    return tgba.GBAGraphs(n_iters=1, pcg_iters=PCG_ITERS, capture=capture)


def capacity(state) -> tuple:
    return state.kf_capacity, state.mp_capacity


def eager_chunk(world, pending, capacity):
    """The chunk program on the bucket's padded problem with a Python gate:
    (Tcw, ptsT) cut back to the snapshot's shapes."""
    K, M, N = tgba.GBAGraphs.bucket(pending, capacity)
    K0, M0 = pending.Tcw.shape[0], pending.ptsT.shape[1]
    prob = tpcg.pad_global_to(pending.prob, K, M, N)
    Tcw = torch.cat([pending.Tcw, torch.eye(4).expand(K - K0, 4, 4)])
    ptsT = torch.cat([pending.ptsT, torch.zeros(3, M - M0)], dim=1)
    Tcw, ptsT = tpcg.global_ba_phase(world["cam_t"], prob, Tcw, ptsT, n_iters=1, pcg_iters=PCG_ITERS,
                                     robust_gate=pending.chunks_done >= ROBUST_AFTER)
    return Tcw[:K0], ptsT[:, :M0]


def test_chunk_and_commit_read_nothing_back(world):
    live = to_torch(world["map"])
    pend = tgba.start_global_ba(live, world["sf"])
    g = graphs()
    with NoHostReads() as mode:
        for _ in range(2):   # ungated, gated
            pend = g.step(pend, world["cam_t"], robust_after=ROBUST_AFTER, capacity=capacity(live))
        g.commit(MapState(*(t.clone() for t in live)), pend, propagate_depth=4)
    assert mode.ops > 1000 and pend.chunks_done == 2


def test_bucketed_chunks_match_jax_and_the_unbucketed_chunks(world):
    live = to_torch(world["map"])
    kw = dict(n_iters=1, pcg_iters=PCG_ITERS, robust_after=ROBUST_AFTER)
    pj = jgba.start_global_ba(world["map"], world["sf"])
    pe = pg = tgba.start_global_ba(live, world["sf"])
    g = graphs()
    K, M, N = g.bucket(pg, capacity(live))
    assert (K, M, N) != (pg.Tcw.shape[0], pg.ptsT.shape[1], pg.prob.cm_pt.shape[0])   # padding happens
    for _ in range(3):
        pj = jgba.step_global_ba(pj, world["cam_j"], **kw)
        pe = tgba.step_global_ba(pe, world["cam_t"], **kw)
        pg = g.step(pg, world["cam_t"], robust_after=ROBUST_AFTER, capacity=capacity(live))
        assert pg.chunks_done == pj.chunks_done and pg.Tcw.shape == pe.Tcw.shape
        assert_poses_close(pg.Tcw.numpy(), pj.Tcw)
        np.testing.assert_allclose(pg.ptsT.numpy(), np.asarray(pj.ptsT), atol=POINT_M, rtol=POINT_REL)
        assert_poses_close(pg.Tcw.numpy(), pe.Tcw.numpy(), UNBUCKETED_POSE_M, UNBUCKETED_POSE_DEG)
        np.testing.assert_allclose(pg.ptsT.numpy(), pe.ptsT.numpy(), atol=UNBUCKETED_POINT_M,
                                   rtol=UNBUCKETED_POINT_REL)
    assert g.captures == 1 and g.replays == 3


def test_ungated_and_gated_chunks_share_one_graph_bit_for_bit(world):
    live = to_torch(world["map"])
    pend = tgba.start_global_ba(live, world["sf"])
    g = graphs()
    for _ in range(2):
        want = eager_chunk(world, pend, capacity(live))
        pend = g.step(pend, world["cam_t"], robust_after=ROBUST_AFTER, capacity=capacity(live))
        assert torch.equal(pend.Tcw, want[0]) and torch.equal(pend.ptsT, want[1])
    assert g.captures == 1 and g.snapshot_loads == 1


def test_two_snapshots_of_one_bucket_each_equal_their_own_eager_run(world):
    """A second snapshot with moved poses and points (the same watermarks,
    so the same bucket) is copied into the statics; the first, resumed
    after it, is copied back."""
    live = to_torch(world["map"])
    moved = live._replace(kf_Tcw=live.kf_Tcw.clone(), mp_pos=live.mp_pos + 0.01)
    moved.kf_Tcw[1:, :3, 3] += 0.02
    a = tgba.start_global_ba(live, world["sf"])
    b = tgba.start_global_ba(moved, world["sf"])
    cap = capacity(live)
    assert tgba.GBAGraphs.bucket(a, cap) == tgba.GBAGraphs.bucket(b, cap)
    g = graphs()
    outs = []
    for pend in (a, b, a, b):
        want = eager_chunk(world, pend, cap)
        out = g.step(pend, world["cam_t"], robust_after=ROBUST_AFTER, capacity=cap)
        assert torch.equal(out.Tcw, want[0]) and torch.equal(out.ptsT, want[1])
        outs.append(out)
    assert not torch.equal(outs[0].Tcw, outs[1].Tcw)
    assert g.captures == 1 and g.snapshot_loads == 4


@pytest.mark.parametrize("depth", [None, 5], ids=["default", "five"])
def test_commit_onto_grown_map_matches_jax_and_the_eager_commit(world, depth):
    """Snapshot before the last keyframe, two chunks, commit after it: the
    post-snapshot keyframe follows its parent as in JAX; depth 5 runs 8
    rounds, the last 3 masked."""
    before, after = world["rec"]["pre"][0], world["map"]
    pj = jgba.start_global_ba(before, world["sf"])
    pt = tgba.start_global_ba(to_torch(before), world["sf"])
    g = graphs()
    for _ in range(2):
        pj = jgba.step_global_ba(pj, world["cam_j"], n_iters=1, pcg_iters=PCG_ITERS, robust_after=ROBUST_AFTER)
        pt = g.step(pt, world["cam_t"], robust_after=ROBUST_AFTER, capacity=capacity(to_torch(after)))
    cj = jgba.commit_global_ba(after, pj, propagate_depth=depth)
    storage = to_torch(after)
    if depth is None:
        g.commit(storage, pt)
    else:
        with NoHostReads():
            g.commit(storage, pt, propagate_depth=depth)
    assert g.capture_log[-1] == ("commit", 4 if depth is None else 8)
    assert_poses_close(storage.kf_Tcw.numpy(), cj.kf_Tcw)
    np.testing.assert_allclose(storage.mp_pos.numpy(), np.asarray(cj.mp_pos), atol=POINT_M, rtol=POINT_REL)
    for name, a in convert.to_numpy(storage).items():
        if name not in ("kf_Tcw", "mp_pos"):
            np.testing.assert_array_equal(a, np.asarray(getattr(cj, name)), err_msg=name)
    eager = tgba.commit_global_ba(to_torch(after), pt, propagate_depth=depth)
    assert all(torch.equal(a, b) for a, b in zip(storage, eager))
    new_kf = int(before.next_kf)
    assert not torch.equal(storage.kf_Tcw[new_kf], to_torch(after).kf_Tcw[new_kf])   # propagated
    assert g.copied_bytes > 0


# ------------------------------------------------------------ on the card --

@pytest.mark.gpu
def test_captured_chunk_and_commit_equal_the_eager_wrappers_on_gpu(world):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the GBA chunk and commit are captured there "
                    "(run python3 chip_smoke.py on the card)")
    from orb_slam2_ros2_tpu_torch.geometry.camera import CameraParams

    dev = torch.device("cuda")
    live = convert.map_state_to_torch(jax.tree.map(np.asarray, world["map"]), dev)
    cam = CameraParams(*(t.to(dev) for t in world["cam_t"]))
    runs = []
    for capture in (False, True):
        g = tgba.GBAGraphs(n_iters=1, pcg_iters=PCG_ITERS, capture=capture)
        pend = tgba.start_global_ba(live, world["sf"])
        chunks = []
        for _ in range(3):   # the first captures, then replays (ungated, gated)
            pend = g.step(pend, cam, robust_after=ROBUST_AFTER, capacity=capacity(live))
            chunks.append((pend.Tcw, pend.ptsT))
        storage = MapState(*(t.clone() for t in live))
        for _ in range(2):
            g.commit(storage, pend, propagate_depth=4)
        runs.append((chunks, storage))
    for (Te, pe), (Tg, pg) in zip(runs[0][0], runs[1][0]):
        assert torch.equal(Te, Tg) and torch.equal(pe, pg)
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
