"""The frame program's graph wrapper, the reference keyframe as a device
tensor and the persistent map storage, on the CPU.

* ``FrameGraphs`` in its eager mode (``capture=False``: the static input
  buffers and output clones of the CUDA path, with the program called where
  the card replays the graph) gives bit-equal poses, stats and maps to the
  direct ``frame_program`` over 10 mapping frames at the small mapping
  configuration with ``auto_grow`` from 4 keyframe and 1024 point slots:
  keyframes are adopted and both stores grow.  It "captures" once at first
  use and once after each capacity change, never per keyframe.
* ``_bookkeep_stats`` and ``frame_program`` give bit-equal results with the
  reference keyframe as a host int and as an int32 [1] tensor, clamping
  included.
* A map assignment copies the changed fields into the storage the graphs
  read (same tensors, new values); a GBA snapshot and a pending Sim3 stage
  taken before it keep their values.  A capacity change re-allocates the
  storage.
* An image tensor already on the SLAM's device is used as it is; an array
  is copied there.
* ``entry(device="cpu")`` runs the eager frame program at the shapes of
  ``__graft_entry__.entry()``.
* On the card (``gpu``, skipped here): an image on the card is taken
  without a read-back; capture and replay bit-equal to the eager program.
"""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_mapping import small_cfg, two_torch_threads  # noqa: F401  (autouse)

import orb_slam2_ros2_tpu_torch.config as tcfg
from orb_slam2_ros2_tpu_torch.io.synthetic import SyntheticStereoDataset
from orb_slam2_ros2_tpu_torch.mapstate.map_state import MapState
from orb_slam2_ros2_tpu_torch.pipeline import system as tsys
from orb_slam2_ros2_tpu_torch.pipeline.frame_graph import FrameGraphs, tree_leaves
from orb_slam2_ros2_tpu_torch.pipeline.tracking import TrackState
from orb_slam2_ros2_tpu_torch.solvers.global_ba import start_global_ba

N_FRAMES = 10


def grow_cfg():
    cfg = small_cfg(tcfg)
    return cfg.replace(map=dataclasses.replace(cfg.map, max_keyframes=4, max_mappoints=1024,
                                               auto_grow=True))


@pytest.fixture(scope="module")
def frames():
    ds = SyntheticStereoDataset(grow_cfg().camera, n_frames=N_FRAMES, speed=0.35, device="cpu")
    return [ds.frame(i) for i in range(N_FRAMES)]


def run(slam, frames):
    out = dict(states=[], poses=[], stats=[], kf=[], caps=[])
    for img_l, img_r, _ in frames:
        caps = (slam.map.kf_capacity, slam.map.mp_capacity)
        n_kf = slam._n_kf
        pose, stats = slam.track(img_l, img_r)
        out["states"].append(slam.state)
        out["poses"].append(pose)
        out["stats"].append(stats)
        out["kf"].append(slam._n_kf > n_kf)
        out["caps"].append(caps)
    return out


@pytest.fixture(scope="module")
def runs(frames):
    direct = tsys.SLAM(grow_cfg(), enable_loop_closing=False, device="cpu")
    wrapped = tsys.SLAM(grow_cfg(), enable_loop_closing=False, device="cpu")
    wrapped._frame_graphs = FrameGraphs(lambda *a, **kw: wrapped._graph_frame_program(*a, **kw), capture=False)
    return dict(direct=run(direct, frames), wrapped=run(wrapped, frames), slams=(direct, wrapped))


def test_wrapper_equals_the_frame_program(runs):
    d, w = runs["direct"], runs["wrapped"]
    assert all(s == TrackState.OK for s in d["states"]) and w["states"] == d["states"]
    assert w["kf"] == d["kf"] and sum(d["kf"][1:]) >= 2
    for a, b in zip(d["poses"], w["poses"]):
        np.testing.assert_array_equal(a, b)
    assert w["stats"] == d["stats"]
    ds, ws = runs["slams"]
    for name, a, b in zip(MapState._fields, ds.map, ws.map):
        assert torch.equal(a, b), name
    for a, b in zip(tree_leaves((ds.last, ds.local, ds.velocity)), tree_leaves((ws.last, ws.local, ws.velocity))):
        assert torch.equal(a, b)


def test_captures_at_first_use_and_after_capacity_changes(runs):
    """One capture at the first tracked frame and one for each capacity the
    tracked frames met after it; the keyframes in between capture nothing."""
    w = runs["wrapped"]
    tracked_caps = w["caps"][1:]
    assert len(set(tracked_caps)) >= 2, "the run must grow its stores"
    g = runs["slams"][1]._frame_graphs
    changes = sum(a != b for a, b in zip(tracked_caps, tracked_caps[1:]))
    assert g.captures == 1 + changes
    assert g.replays == N_FRAMES - 1
    assert {th for th, _, _ in g.capture_log} == {3.0}


def test_ref_kf_tensor_path_equals_int_path(runs, frames):
    slam = runs["slams"][0]
    st = slam.map
    K = st.kf_capacity
    mp_ids = slam.last.mp_ids
    for k in (-3, 0, 1, slam._n_kf - 1, K + 5):
        a = tsys._bookkeep_stats(st, mp_ids, k)
        b = tsys._bookkeep_stats(st, mp_ids, torch.tensor([k], dtype=torch.int32))
        assert torch.equal(a, b), k
    assert not torch.equal(tsys._bookkeep_stats(st, mp_ids, 0), tsys._bookkeep_stats(st, mp_ids, 1))

    outs = []
    for ref in (1, torch.tensor([1], dtype=torch.int32)):
        m = MapState(*(t.clone() for t in st))
        outs.append(slam.frame_program(*frames[2][:2], slam.last, slam.velocity, slam.local, m, ref))
    for a, b in zip(tree_leaves(outs[0]), tree_leaves(outs[1])):
        assert torch.equal(a, b)


def test_map_storage_copy_keeps_gba_snapshot_and_pending_cascade():
    """Assigning a new map copies into the storage; what the loop closer
    and the background GBA hold keeps its values."""
    from test_torch_loop_slice import KF_CUR, setup_slams

    _, ts = setup_slams()
    ts._dispatch_loop_detect(KF_CUR)
    ts._resolve_pending_loop()
    pend_sim3 = ts.loop_closer.pending_sim3
    assert pend_sim3 is not None and pend_sim3["stage"] == "a"
    gba = start_global_ba(ts.map, ts.cfg.orb.scale_factor)
    held = [t.clone() for t in tree_leaves((gba, [v for v in pend_sim3.values() if torch.is_tensor(v)]))]

    storage = list(ts.map)
    bytes0 = ts.map_copy_bytes
    new = ts.map._replace(mp_pos=ts.map.mp_pos + 1.0, kf_Tcw=ts.map.kf_Tcw * 2.0,
                          mp_visible=ts.map.mp_visible + 3)
    ts.map = new
    assert all(a is b for a, b in zip(ts.map, storage))
    assert torch.equal(ts.map.mp_pos, new.mp_pos) and torch.equal(ts.map.mp_visible, new.mp_visible)
    assert ts.map_copy_bytes - bytes0 == sum(t.numel() * t.element_size()
                                             for t in (new.mp_pos, new.kf_Tcw, new.mp_visible))
    for a, b in zip(held, tree_leaves((gba, [v for v in pend_sim3.values() if torch.is_tensor(v)]))):
        assert torch.equal(a, b)

    ts._grow(mp_capacity=2 * ts.map.mp_capacity)
    assert ts.map.mp_pos.shape[0] == 2 * storage[MapState._fields.index("mp_pos")].shape[0]
    assert ts.map.kf_Tcw is not storage[0] and torch.equal(ts.map.kf_Tcw, new.kf_Tcw)


def test_images_on_the_slam_device_are_taken_as_they_are():
    slam = tsys.SLAM(grow_cfg(), enable_loop_closing=False, device="cpu")
    img = torch.zeros((192, 320), dtype=torch.uint8)
    assert slam._to_device(img) is img
    arr = np.arange(192 * 320, dtype=np.uint8).reshape(192, 320)
    staged = slam._to_device(arr)
    assert staged.device == slam.device and np.array_equal(staged.numpy(), arr)


def test_entry_runs_the_frame_program_on_cpu():
    from orb_slam2_ros2_tpu_torch.entry import entry

    fn, args = entry(device="cpu")
    img_l, img_r, last, velocity, local, mapstate, ref_kf = args
    assert tuple(img_l.shape) == (192, 320) and last.mp_ids.shape == (512,)
    assert mapstate.kf_capacity == 64 and mapstate.mp_capacity == 16384 and ref_kf == 0
    new_state, vel, host_vec, m, local2 = fn(*args)
    assert m is mapstate and host_vec.shape == (len(tsys.STAT_KEYS) + 32,)
    assert torch.isfinite(host_vec).all() and int(host_vec[4]) >= 30   # n_inliers
    assert local2.mp_ids.shape == (4096,) and new_state.Tcw.shape == (4, 4)


# ------------------------------------------------------------ on the card --

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the frame graph captures the CUDA kernels "
                    "(run python3 chip_smoke.py on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_capture_and_replay_equal_the_eager_program_on_gpu(cuda_device):
    """Mapping frames through the captured graph and through the eager
    program on the card: bit-equal poses and stats, one capture per
    capacity."""
    cfg = grow_cfg()
    ds = SyntheticStereoDataset(cfg.camera, n_frames=N_FRAMES, speed=0.35, device=cuda_device)
    frames = [ds.frame(i) for i in range(N_FRAMES)]
    graph = tsys.SLAM(cfg, enable_loop_closing=False, device=cuda_device)
    eager = tsys.SLAM(cfg, enable_loop_closing=False, device=cuda_device)
    eager._frame_graphs = None
    # an image already on the card is taken as it is: no read-back, no copy
    img = frames[0][0]
    torch.cuda.set_sync_debug_mode("error")
    try:
        assert graph._to_device(img) is img
    finally:
        torch.cuda.set_sync_debug_mode(0)
    g, e = run(graph, frames), run(eager, frames)
    assert g["states"] == e["states"] and g["kf"] == e["kf"]
    for a, b in zip(g["poses"], e["poses"]):
        np.testing.assert_array_equal(a, b)
    assert g["stats"] == e["stats"]
    caps = g["caps"][1:]
    assert graph._frame_graphs.captures == 1 + sum(a != b for a, b in zip(caps, caps[1:]))
