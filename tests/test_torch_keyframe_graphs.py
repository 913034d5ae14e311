"""The keyframe programs through ``frame_graph.KeyframeGraphs`` with int32
[1] tensor ids, on the CPU, against the JAX package's modules.

``KeyframeGraphs(capture=False)`` runs the CUDA path's static-buffer
wrappers with the program called where the card replays the graph: the ids
and the frame go into static inputs, the map storage is passed as it is and
each program writes the fields it changed into it.  On the inputs the JAX
run of ``tests/test_torch_mapping.py`` recorded (its ``world`` fixture):

* ``map_front``, every ``(do_ba, do_cull)`` variant of the tail and the
  aborted BA's ``cull_kfs`` equal the JAX modules as
  ``tests/test_torch_mapping.py`` holds them (integer tables exact, poses
  within 1 mm / 0.01°, points within 5 mm) and equal the eager program bit
  for bit, storage and outputs;
* every program runs under ``torch_host_reads.NoHostReads``: no host read
  and no data-sized output, what a CUDA graph cannot capture;
* a second call with other inputs copied into the same statics (another
  keyframe id, another map in the same storage) equals its own eager run:
  nothing was baked in;
* what the storage's other holders took before (a GBA snapshot) keeps its
  values, and ``copied_bytes`` counts the fields written.

On the card (``gpu``, skipped here) the captured replays equal the eager
programs bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mapping import (  # noqa: F401  (two_torch_threads is autouse, world a fixture)
    assert_maps_agree, small_cfg, to_torch, two_torch_threads, world)
from torch_host_reads import HostReadError, NoHostReads

import orb_slam2_ros2_tpu_torch.config as tcfg
from orb_slam2_ros2_tpu_torch import convert
from orb_slam2_ros2_tpu_torch.mapstate.map_state import MapState
from orb_slam2_ros2_tpu_torch.pipeline.frame_graph import KeyframeGraphs, tree_leaves, tree_map
from orb_slam2_ros2_tpu_torch.pipeline.system import SLAM as TSLAM
from orb_slam2_ros2_tpu_torch.solvers.global_ba import start_global_ba

VARIANTS = [(True, True), (True, False), (False, True), (False, False)]


def t32(v) -> torch.Tensor:
    return torch.tensor([int(v)], dtype=torch.int32)


def graphs(slam, capture=False) -> KeyframeGraphs:
    return KeyframeGraphs(slam.map_front_program, slam.map_tail_program, slam._cull_kfs, slam.bookkeep_program,
                          capture=capture)


def clone_map(m) -> MapState:
    return MapState(*(t.clone() for t in m))


def assert_bit_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def changed_bytes(before: MapState, after: MapState) -> int:
    return sum(t.numel() * t.element_size() for a, t in zip(before, after) if t is not a)


@pytest.fixture(scope="module")
def slam():
    return TSLAM(small_cfg(tcfg), enable_loop_closing=False, device="cpu")


def front_inputs(world):
    state, frame, Tcw, mp_ids, fid = world["rec"]["pre"]
    return (to_torch(state), convert.stereo_frame_to_torch(frame, "cpu"), torch.from_numpy(np.array(Tcw)),
            torch.from_numpy(np.array(mp_ids)), int(fid))


def test_map_front_graph_matches_jax_and_the_eager_program(world, slam):
    rec, kf = world["rec"], world["rec"]["kf"]
    state, frame, Tcw, mp_ids, fid = front_inputs(world)
    g = graphs(slam)
    storage = clone_map(state)
    ids = t32(fid), t32(kf)
    with NoHostReads():
        local, kf_mp, kf_Tcw = g.map_front(storage, frame, Tcw, mp_ids, *ids)
    jmap = rec["fuse_back"]
    assert_maps_agree(jmap, storage)
    jlocal = world["slam"]._snapshot(jmap, jnp.int32(kf))
    np.testing.assert_array_equal(local.mp_ids.numpy(), np.asarray(jlocal.mp_ids))
    np.testing.assert_array_equal(local.kf_ids.numpy(), np.asarray(jlocal.kf_ids))
    np.testing.assert_array_equal(kf_mp.numpy(), np.asarray(jmap.kf_mp_idx[kf]))
    np.testing.assert_allclose(kf_Tcw.numpy(), np.asarray(jmap.kf_Tcw[kf]), atol=1e-5)

    eager_map, *eager_out = slam.map_front_program(state, frame, Tcw, mp_ids, fid, kf)
    assert_bit_equal(storage, eager_map)
    assert_bit_equal((local, kf_mp, kf_Tcw), tuple(eager_out))
    assert g.copied_bytes == changed_bytes(state, eager_map) > 0

    # the next keyframe (the same frame one id on) into the same statics
    before, ids = clone_map(storage), (t32(fid + 1), t32(kf + 1))
    with NoHostReads():
        out2 = g.map_front(storage, frame, Tcw @ Tcw, mp_ids, *ids)
    eager2_map, *eager2_out = slam.map_front_program(before, frame, Tcw @ Tcw, mp_ids, fid + 1, kf + 1)
    assert int(storage.next_kf) == kf + 2 and int(storage.kf_frame_id[kf + 1]) == fid + 1
    assert_bit_equal(storage, eager2_map)
    assert_bit_equal(out2, tuple(eager2_out))
    assert g.captures == 1 and g.replays == 2   # the eager mode's first call runs on the statics too


def jax_tail(world, do_ba, do_cull):
    """The JAX tail's map: the recorded states where the run made them, the
    jitted cull module on the tail's input otherwise."""
    rec, P = world["rec"], world["P"]
    if do_ba:
        return rec["cull_kf"] if do_cull else rec["local_ba"]
    return P["cull_kf"](rec["tail"], jnp.int32(rec["kf"])) if do_cull else rec["tail"]


@pytest.mark.parametrize("do_ba,do_cull", VARIANTS)
def test_map_tail_variant_graph_matches_jax_and_the_eager_program(world, slam, do_ba, do_cull):
    rec, kf = world["rec"], world["rec"]["kf"]
    state = to_torch(rec["tail"])
    g = graphs(slam)
    storage, k = clone_map(state), t32(kf)
    with NoHostReads():
        local = g.map_tail(storage, k, do_ba, do_cull)
    jmap = jax_tail(world, do_ba, do_cull)
    assert_maps_agree(jmap, storage)
    jlocal = world["slam"]._snapshot(jmap, jnp.int32(kf))
    np.testing.assert_array_equal(local.mp_ids.numpy(), np.asarray(jlocal.mp_ids))
    eager_map, eager_local = slam.map_tail_program(state, kf, do_ba, do_cull)
    assert_bit_equal(storage, eager_map)
    assert_bit_equal(local, eager_local)
    assert g.copied_bytes == changed_bytes(state, eager_map)

    # another map in the same storage, another keyframe, the same statics
    other = to_torch(rec["insert"])
    convert_bytes = g.copied_bytes
    for dst, src in zip(storage, other):
        dst.copy_(src)
    k = t32(kf - 1)
    with NoHostReads():
        local2 = g.map_tail(storage, k, do_ba, do_cull)
    eager2_map, eager2_local = slam.map_tail_program(other, kf - 1, do_ba, do_cull)
    assert_bit_equal(storage, eager2_map)
    assert_bit_equal(local2, eager2_local)
    assert g.captures == 1 and g.replays == 2 and g.copied_bytes == 2 * convert_bytes


def test_cull_kfs_graph_matches_jax_and_the_eager_program(world, slam):
    """The keyframe cull of an aborted BA, on the state the last local BA
    left (the JAX run's configured cull followed it)."""
    rec, kf = world["rec"], world["rec"]["kf"]
    state = to_torch(rec["local_ba"])
    g = graphs(slam)
    storage, k = clone_map(state), t32(kf)
    with NoHostReads():
        g.cull_kfs(storage, k)
    assert_maps_agree(rec["cull_kf"], storage)
    assert_bit_equal(storage, slam._cull_kfs(state, kf))
    other = to_torch(rec["tail"])
    for dst, src in zip(storage, other):
        dst.copy_(src)
    k = t32(kf - 1)
    with NoHostReads():
        g.cull_kfs(storage, k)
    assert_bit_equal(storage, slam._cull_kfs(other, kf - 1))
    assert g.captures == 1 and g.replays == 2   # the eager mode's first call runs on the statics too


def test_storage_holders_keep_their_values(world, slam):
    """A GBA snapshot taken from the storage before a tail writes into it
    keeps its values; a storage that moved is refused."""
    rec, kf = world["rec"], world["rec"]["kf"]
    g = graphs(slam)
    storage = to_torch(rec["tail"])
    gba = start_global_ba(storage, slam.cfg.orb.scale_factor)
    held = [t.clone() for t in tree_leaves(gba)]
    g.map_tail(storage, t32(kf), True, True)
    assert not torch.equal(storage.kf_Tcw, to_torch(rec["tail"]).kf_Tcw)
    for a, b in zip(held, tree_leaves(gba)):
        assert torch.equal(a, b)
    with pytest.raises(RuntimeError, match="storage moved"):
        g.map_tail(clone_map(storage), t32(kf), True, True)
    g.clear()
    g.map_tail(clone_map(storage), t32(kf), True, True)


def test_host_read_detector_refuses_what_a_graph_cannot_capture(world):
    """The detector itself: a host int id through the old indexing form (a
    0-d tensor index reads the host), a mask index and ``.item()``."""
    state = to_torch(world["rec"]["tail"])
    for bad in (lambda: state.covis[torch.tensor(1)].sum(), lambda: state.mp_pos[state.mp_valid],
                lambda: state.next_kf.item()):
        with pytest.raises(HostReadError), NoHostReads():
            bad()
    with NoHostReads() as mode:
        state.covis.index_select(0, torch.ones((1,), dtype=torch.long))
    assert mode.ops >= 1


# ------------------------------------------------------------ on the card --

@pytest.mark.gpu
def test_captured_keyframe_programs_equal_the_eager_programs_on_gpu(world):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the keyframe graphs are captured there "
                    "(run python3 chip_smoke.py on the card)")
    dev = torch.device("cuda")
    slam = TSLAM(small_cfg(tcfg), enable_loop_closing=False, device=dev)
    kf = world["rec"]["kf"]
    state, frame, Tcw, mp_ids, fid = front_inputs(world)
    state, frame, Tcw, mp_ids = (tree_map(lambda t: t.to(dev), x) for x in (state, frame, Tcw, mp_ids))
    g = graphs(slam, capture=True)
    storage = clone_map(state)
    for i in range(3):   # the first call runs eagerly and captures; then replays
        src = clone_map(state)
        for dst, s in zip(storage, src):
            dst.copy_(s)
        out = g.map_front(storage, frame, Tcw, mp_ids, fid, kf)
        eager_map, *eager_out = slam.map_front_program(src, frame, Tcw, mp_ids, fid, kf)
        assert_bit_equal(storage, eager_map)
        assert_bit_equal(out, tuple(eager_out))
    assert g.captures == 1 and g.replays == 2
