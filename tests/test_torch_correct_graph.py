"""The loop correction's front and its loop-group fuses through
``loop_closing.LoopGraphs`` with int32 [1] tensor ids, on the CPU, against
the JAX package's ``correct_group`` → ``attach_matched_mps`` →
``fuse_group_into_kfs``.

``LoopGraphs(capture=False)`` runs the CUDA path's static-buffer wrappers
with each program called where the card replays its graph; ``correct_front``
and ``fuse_one`` write into the map storage they are given.  On the
12-keyframe ring of ``tests/test_torch_loop_closing.py`` and JAX's verified
cascade output there:

* ``correct_front`` then one ``fuse_one`` for each of the current
  keyframe's top-16 covisible neighbours equals JAX within that file's
  tolerances (integer tables exact, poses within 1e-4 m / 1e-3°, points
  within 1e-3 m; ``S_nc`` within 1e-6), and the eager programs with
  host-int ids bit for bit, under ``torch_host_reads.NoHostReads``;
* the rebind test: another pair, Sim3 and fuse list through the same
  wrappers equal their own eager run;
* ``LoopCloser.warmup`` captures every loop graph and leaves the map as it
  was, so ``correct`` on the storage after it captures nothing, and equals
  ``correct`` on a copy; ``grow`` drops the graphs.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_loop_closing import (  # noqa: F401  (two_torch_threads is autouse, ring a fixture)
    GEOM, assert_maps_agree, assert_sim3_close, np_tree, ring, t_sim3, two_torch_threads)
from torch_host_reads import NoHostReads

from orb_slam2_ros2_tpu.pipeline import loop_closing as jlc
from orb_slam2_ros2_tpu_torch import convert
from orb_slam2_ros2_tpu_torch.geometry import sim3 as tsim3
from orb_slam2_ros2_tpu_torch.mapstate.map_state import MapState
from orb_slam2_ros2_tpu_torch.pipeline import loop_closing as tlc

CUR, CAND = 11, 0
OTHER = (10, 1)   # the rebind test's pair


def fuse_ids(covis_row: np.ndarray, mw: int) -> list:
    """The current keyframe's top-16 covisible neighbours, as ``correct``
    picks them (numpy's argsort, as JAX's)."""
    ids = np.argsort(-covis_row)[:16]
    return ids[covis_row[ids] >= mw].tolist()


def copy_of(state) -> MapState:
    return MapState(*(t.clone() for t in state))


def assert_bit_equal(a: MapState, b: MapState, what: str):
    for name, x, y in zip(MapState._fields, a, b):
        assert torch.equal(x, y), f"{what}: {name}"


@pytest.fixture(scope="module")
def jax_correct(ring):
    """JAX's front (group correction + attach) and fuses on the ring."""
    sj = ring["sj"]
    mw = ring["cfg_j"].mapping.min_covis_weight
    s1j, S_nc, gmask = jlc.correct_group(sj, CUR, CAND, ring["S12"], min_covis_weight=mw)
    s2j = jax.jit(jlc.attach_matched_mps)(s1j, CUR, ring["matched"])
    ids = fuse_ids(np.asarray(s2j.covis[CUR]), mw)
    fj = jax.jit(partial(jlc.fuse_group_into_kfs, **GEOM))(
        s2j, ring["cam_j"], ring["group"], jnp.asarray(ids + [-1] * (16 - len(ids)), jnp.int32))
    return dict(front=s2j, S_nc=S_nc, gmask=gmask, pre=sj.covis > 0, ids=ids, fused=fj)


@pytest.fixture(scope="module")
def inputs(ring):
    return dict(S12=t_sim3(ring["S12"]), matched=torch.from_numpy(np.asarray(ring["matched"])),
                group=convert.local_map_to_torch(np_tree(ring["group"]), "cpu"))


def graph_run(g, storage, cam, pair, S12, matched, group, ids=None):
    """``correct_front`` and the fuses through ``g`` into ``storage``, each
    under ``NoHostReads``; the fuse list read between them as ``correct``
    reads it, unless given.  Returns (S_nc, group_mask, pre_conn, ids)."""
    with NoHostReads():
        S_nc, gmask, pre = g.correct_front(storage, *pair, S12, matched)
    if ids is None:
        ids = fuse_ids(storage.covis[pair[0]].numpy(), g.eager["correct_front"].keywords["min_covis_weight"])
    for kf in ids:
        with NoHostReads():
            g.fuse_one(storage, cam, kf, group)
    return S_nc, gmask, pre, ids


def eager_run(g, state, cam, pair, S12, matched, group, ids):
    st, S_nc, gmask, pre = g.eager["correct_front"](state, *pair, S12, matched)
    for kf in ids:
        st = g.eager["fuse_one"](st, cam, kf, group)
    return st, S_nc, gmask, pre


def test_correct_front_and_fuses_match_jax_and_eager(ring, jax_correct, inputs):
    j = jax_correct
    g = tlc.LoopGraphs(ring["cfg_t"], ring["ct"].vocab, capture=False)
    storage = copy_of(ring["stt"])
    ptrs = [t.data_ptr() for t in storage]
    S_nc, gmask, pre, ids = graph_run(g, storage, ring["cam_t"], (CUR, CAND), inputs["S12"], inputs["matched"],
                                      inputs["group"])
    assert [t.data_ptr() for t in storage] == ptrs
    assert ids == j["ids"] and len(ids) >= 2
    assert_maps_agree(j["fused"], storage)
    assert_sim3_close(S_nc, j["S_nc"], tol=1e-6)
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(j["gmask"]))
    np.testing.assert_array_equal(pre.numpy(), np.asarray(j["pre"]))
    st, S_nc_e, gmask_e, pre_e = eager_run(g, ring["stt"], ring["cam_t"], (CUR, CAND), inputs["S12"],
                                           inputs["matched"], inputs["group"], ids)
    assert_bit_equal(storage, st, "the eager programs")
    for a, b in zip((*S_nc, gmask, pre), (*S_nc_e, gmask_e, pre_e)):
        assert torch.equal(a, b)
    assert g.capture_log == ["correct_front", "fuse_one"] and g.replays == 1 + len(ids)
    assert g.copied_bytes > 0


def test_correct_front_and_fuse_rebind(ring, inputs):
    """(11, 0) and then (10, 1) with another Sim3 and fuse list, through the
    same wrappers on the same storage (reset in place in between): each
    bit-equal to its own eager run."""
    g = tlc.LoopGraphs(ring["cfg_t"], ring["ct"].vocab, capture=False)
    stt, cam = ring["stt"], ring["cam_t"]
    storage = copy_of(stt)
    S12 = inputs["S12"]
    runs = (((CUR, CAND), S12, [CUR, 10]),
            (OTHER, tsim3.Sim3(R=S12.R, t=S12.t + 0.05, s=S12.s), [OTHER[0], 9, 8]))
    results = []
    for pair, S, ids in runs:
        torch._foreach_copy_(list(storage), list(stt))
        out = graph_run(g, storage, cam, pair, S, inputs["matched"], inputs["group"], ids)
        want = eager_run(g, stt, cam, pair, S, inputs["matched"], inputs["group"], ids)
        assert_bit_equal(storage, want[0], f"pair {pair}")
        for a, b in zip((*out[0], *out[1:3]), (*want[1], *want[2:])):
            assert torch.equal(a, b), f"pair {pair}"
        results.append(copy_of(storage))
    assert g.captures == 2 and g.replays == 2 + 5
    le = results[1].loop_edges.numpy()
    assert le[0].tolist() == list(OTHER), "the second pair's loop edge"
    assert not torch.equal(results[0].kf_Tcw, results[1].kf_Tcw)


def test_warmup_captures_what_correct_meets_and_grow_drops(ring, inputs):
    """After ``warmup`` on the storage (the map left bit for bit), an
    in-place ``correct`` captures nothing and equals ``correct`` on a copy;
    ``grow`` drops the loop graphs."""
    stt = ring["stt"]
    lc = tlc.LoopCloser(ring["cfg_t"], ring["ct"].vocab)
    storage = copy_of(stt)
    lc.warmup(storage, ring["cam_t"])
    assert_bit_equal(storage, stt, "the warm-up")
    g = lc.graphs
    assert sorted(g.capture_log) == sorted(["detect", "frame_detect", "sim3_a", "sim3_b", "sim3_c",
                                            "correct_front", "fuse_one"])
    captures, essential = g.captures, lc.essential.captures
    args = (ring["cam_t"], CUR, CAND, inputs["S12"], inputs["matched"], inputs["group"])
    out = lc.correct(storage, *args, run_gba=False, in_place=True)
    assert lc.graphs is g and g.captures == captures and lc.essential.captures == essential
    copied = tlc.LoopCloser(ring["cfg_t"], ring["ct"].vocab).correct(stt, *args, run_gba=False)
    assert_bit_equal(out, copied, "in place against a copy")
    lc.grow(2 * stt.kf_capacity)
    assert lc.graphs is None and lc.essential is None
