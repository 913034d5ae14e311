"""End-to-end parity of the port's full SLAM without loop closing (keyframe
decision, insertion, the mapping front half and the deferred tail) with the
JAX package's, on the CPU, at the small mapping configuration of
``tests/test_slam_e2e.py``, in the default deferred-tail mode.

Frames are rendered once by the JAX package and handed to both systems.
The JAX system runs its keyframe programs as the same module functions
jitted one by one (``test_torch_mapping.use_module_programs``: XLA's fusion
of the whole programs would double the file's compile time); its host loop
is its own.  The port runs with ``max_keyframes=8`` / ``max_mappoints=2048``
and ``auto_grow``, so its stores double during the run while the JAX system
keeps its default capacities: growth must not change a result.  Checks
(shared with ``tests/test_torch_mapping_sync.py``, which runs the
synchronous mode with the fused JAX programs): the same TrackState sequence
and the same frames promoted to keyframes, every pose within 1 cm / 0.1°,
equal ``n_keyframes``, ``n_mappoints`` within 3%, and
``final_trajectory()`` within the pose tolerance.  The port's keyframe
programs are held against the JAX modules on the inputs the JAX run gave
its last keyframe; the host logic (keyframe decision, tail cadence, BA
abort) against the JAX system's on the same bookkeeping.
"""

import dataclasses
from collections import namedtuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mapping import (  # noqa: F401  (two_torch_threads is autouse)
    assert_maps_agree, rot_deg, small_cfg, two_torch_threads, use_module_programs)

import orb_slam2_ros2_tpu.config as jcfg
import orb_slam2_ros2_tpu_torch.config as tcfg
from orb_slam2_ros2_tpu.io.synthetic import SyntheticStereoDataset as JDataset
from orb_slam2_ros2_tpu.pipeline.system import SLAM as JSLAM
from orb_slam2_ros2_tpu_torch import convert
from orb_slam2_ros2_tpu_torch.pipeline.system import SLAM as TSLAM

N_FRAMES = 10
POSE_TOL_M, POSE_TOL_DEG = 1e-2, 0.1
MP_REL_TOL = 0.03
GROW = dict(max_keyframes=8, max_mappoints=2048, auto_grow=True)


def slice_cfg(mod, synchronous=False, **map_kw):
    cfg = small_cfg(mod, synchronous=synchronous)
    return cfg.replace(map=dataclasses.replace(cfg.map, **map_kw))


def render(n=N_FRAMES):
    ds = JDataset(small_cfg(jcfg).camera, n_frames=n, speed=0.35)
    return [tuple(np.asarray(x) for x in ds.frame(i)) for i in range(n)]


def run(slam, frames) -> dict:
    """Track every frame, then flush.  Per frame: TrackState, keyframe flag,
    pose and the store capacities after it."""
    out = dict(states=[], kf=[], poses=[], caps=[])
    for img_l, img_r, _ in frames:
        n_kf = slam._n_kf
        pose, _ = slam.track(img_l, img_r)
        out["states"].append(slam.state.name)
        out["kf"].append(slam._n_kf > n_kf)
        out["poses"].append(pose)
        out["caps"].append((int(slam.map.kf_valid.shape[0]), int(slam.map.mp_valid.shape[0])))
    slam.flush()
    out.update(slam=slam, final=slam.final_trajectory(), n_keyframes=slam.n_keyframes,
               n_mappoints=slam.n_mappoints)
    return out


def _check_states(j, t):
    assert t["states"] == j["states"] and all(s == "OK" for s in t["states"])
    assert t["kf"] == j["kf"] and sum(j["kf"][1:]) >= 3


def _poses_close(Pj, Pt):
    Pj, Pt = np.stack(Pj), np.stack(Pt)
    assert np.abs(Pj[:, :3, 3] - Pt[:, :3, 3]).max() <= POSE_TOL_M
    assert rot_deg(Pj, Pt).max() <= POSE_TOL_DEG


def _check_poses(j, t):
    _poses_close(j["poses"], t["poses"])


def _check_map_size(j, t):
    assert t["n_keyframes"] == j["n_keyframes"]
    assert abs(t["n_mappoints"] - j["n_mappoints"]) <= MP_REL_TOL * j["n_mappoints"]


def _check_final_trajectory(j, t):
    assert [f for f, _ in t["final"]] == [f for f, _ in j["final"]] == list(range(len(j["states"])))
    _poses_close([T for _, T in j["final"]], [T for _, T in t["final"]])


RUN_CHECKS = {"states_and_keyframes": _check_states, "poses": _check_poses,
              "map_size": _check_map_size, "final_trajectory": _check_final_trajectory}


# ------------------------------------------------- the deferred-tail run --

@pytest.fixture(scope="module")
def runs():
    frames = render()
    jslam = JSLAM(slice_cfg(jcfg), enable_loop_closing=False)
    record = {}
    use_module_programs(jslam, record)
    j = run(jslam, frames)
    t = run(TSLAM(slice_cfg(tcfg, **GROW), enable_loop_closing=False, device="cpu"), frames)
    return dict(jax=j, torch=t, rec=record)


@pytest.mark.parametrize("check", list(RUN_CHECKS))
def test_deferred_mapping_matches_jax(runs, check):
    RUN_CHECKS[check](runs["jax"], runs["torch"])


def test_auto_grow_doubles_capacities_as_jax_does(runs):
    """The port's stores double by the JAX system's rule — keyframes when
    the next id reaches capacity − 2, points when the allocator comes within
    2·max_keypoints of the capacity — and (above) nothing else changes."""
    kf_cap, mp_cap = GROW["max_keyframes"], GROW["max_mappoints"]
    headroom = 2 * small_cfg(tcfg).orb.max_keypoints
    n_kf = 0
    expected = []
    jmap = runs["jax"]["slam"].map
    for promoted in runs["jax"]["kf"]:
        if promoted:
            if n_kf > 0:  # insertions after initialization
                kf_cap *= 2 if n_kf >= kf_cap - 2 else 1
            n_kf += 1
        expected.append(kf_cap)
    assert [c for c, _ in runs["torch"]["caps"]] == expected and expected[-1] > GROW["max_keyframes"]
    final_mp = runs["torch"]["caps"][-1][1]
    assert final_mp > mp_cap and int(jmap.next_mp) + headroom < 2 * final_mp
    assert [c for c in runs["jax"]["caps"]] == [(64, 16384)] * N_FRAMES


def test_map_front_program_matches_jax(runs):
    """The port's front program on the inputs of the JAX run's last
    keyframe: the map, the local-map snapshot and the adopted feature→point
    table and pose."""
    rec = runs["rec"]
    state, frame, Tcw, mp_ids, fid = rec["pre"]
    jmap, kf = rec["fuse_back"], rec["kf"]
    jlocal = runs["jax"]["slam"]._snapshot(jmap, jnp.int32(kf))
    slam = TSLAM(slice_cfg(tcfg), enable_loop_closing=False, device="cpu")
    tmap, tlocal, tmp, tTcw = slam.map_front_program(
        convert.map_state_to_torch(state, "cpu"), convert.stereo_frame_to_torch(frame, "cpu"),
        torch.from_numpy(np.array(Tcw)), torch.from_numpy(np.array(mp_ids)), int(fid), kf)
    assert_maps_agree(jmap, tmap)
    np.testing.assert_array_equal(tlocal.mp_ids.numpy(), np.asarray(jlocal.mp_ids))
    np.testing.assert_array_equal(tlocal.kf_ids.numpy(), np.asarray(jlocal.kf_ids))
    np.testing.assert_array_equal(tmp.numpy(), np.asarray(jmap.kf_mp_idx[kf]))
    np.testing.assert_allclose(tTcw.numpy(), np.asarray(jmap.kf_Tcw[kf]), atol=1e-5)


@pytest.mark.parametrize("program", ["tail", "abort_cull"])
def test_map_tail_program_matches_jax(runs, program):
    """The last deferred tail of the JAX run (local BA + keyframe cull +
    snapshot), and the keyframe cull of a BA that a new keyframe aborted."""
    rec = runs["rec"]
    slam = TSLAM(slice_cfg(tcfg), enable_loop_closing=False, device="cpu")
    if program == "tail":
        kf, jmap = rec["kf"], rec["cull_kf"]
        tmap, tlocal = slam.map_tail_program(convert.map_state_to_torch(rec["tail"], "cpu"), kf,
                                             True, True)
        jlocal = runs["jax"]["slam"]._snapshot(jmap, jnp.int32(kf))
        np.testing.assert_array_equal(tlocal.mp_ids.numpy(), np.asarray(jlocal.mp_ids))
    else:
        (state, kf), jmap = rec["abort_cull_in"], rec["abort_cull"]
        tmap = slam._cull_kfs(convert.map_state_to_torch(state, "cpu"), kf)
    assert_maps_agree(jmap, tmap)


# ------------------------------------------------------- the host logic --

STATS = namedtuple("STATS", "n_tracked n_ref_matches n_close_tracked n_close_untracked")


@pytest.mark.parametrize("variant", ["default", "localization", "full_store", "full_store_grow"])
def test_need_keyframe_matches_jax(variant):
    """The keyframe decision (c1a/c1b/c1c gated by c2) over a grid of
    bookkeeping states and frame statistics."""
    kw, map_kw = {}, {}
    if variant == "localization":
        kw = dict(only_tracking=True)
    elif variant.startswith("full_store"):
        map_kw = dict(max_keyframes=4, auto_grow=variant.endswith("grow"))

    def cfg(mod):
        c = slice_cfg(mod, **map_kw)
        return c.replace(tracking=dataclasses.replace(c.tracking, **kw))

    js = JSLAM(cfg(jcfg), enable_loop_closing=False)
    ts = TSLAM(cfg(tcfg), enable_loop_closing=False, device="cpu")
    js.frame_id = 1000
    decisions = {"jax": [], "torch": []}
    grid = [(since, pending, n_kf, st)
            for since in (0, 2, 4, 11) for pending in (None, 1) for n_kf in (1, 2, 3)
            for st in (STATS(90, 400, 200, 10), STATS(150, 400, 200, 10), STATS(350, 400, 200, 10),
                       STATS(350, 400, 40, 120), STATS(0, 0, 0, 0))]
    for since, pending, n_kf, st in grid:
        for name, s in (("jax", js), ("torch", ts)):
            s.frames_since_kf, s._n_kf = since, n_kf
            s._pending_kf = None if pending is None else ((pending, pending) if name == "jax" else pending)
            decisions[name].append(s._need_keyframe(st._asdict()))
    assert decisions["torch"] == decisions["jax"]
    if variant == "localization":
        assert not any(decisions["jax"])
    else:
        assert 0 < sum(decisions["jax"]) < len(grid)


Cur = namedtuple("Cur", "frame Tcw mp_ids")


def _mock_programs(slam, name, log):
    """Replace a system's keyframe programs by recorders of (program, kf,
    flags), so the host logic runs alone."""
    if name == "jax":
        def front(m, frame, Tcw, mp_ids, fid, cam):
            log.append(("front", slam._n_kf))
            return m, slam._n_kf, None, mp_ids, Tcw
        slam._map_front = front
        slam._map_tail_variants = {
            (ba, cull): (lambda m, kf, cam, ba=ba, cull=cull:
                         (log.append(("tail", int(kf), ba, cull)), (m, None, None))[1])
            for ba in (True, False) for cull in (True, False)}
        slam._cull_kfs = lambda m, kf: (log.append(("cull", int(kf))), m)[1]
    else:
        def front(m, frame, Tcw, mp_ids, fid, kf_id):
            log.append(("front", kf_id))
            return m, None, mp_ids, Tcw
        slam.map_front_program = front
        slam.map_tail_program = lambda m, kf, ba, cull: (log.append(("tail", kf, ba, cull)), (m, None))[1]
        slam._cull_kfs = lambda m, kf: (log.append(("cull", kf)), m)[1]


@pytest.mark.parametrize("synchronous,ba_stride,cull_stride,force_ba_every",
                         [(False, 1, 1, 2), (False, 2, 2, 2), (False, 1, 1, 1), (False, 0, 1, 3),
                          (True, 2, 2, 2)])
def test_tail_cadence_matches_jax(synchronous, ba_stride, cull_stride, force_ba_every):
    """Which tail runs when: the BA / keyframe-cull strides, the BA abort
    when the next keyframe arrives first (bounded by ``force_ba_every``),
    idle-frame tails and ``flush``."""
    def cfg(mod):
        c = slice_cfg(mod, synchronous=synchronous)
        return c.replace(mapping=dataclasses.replace(
            c.mapping, ba_stride=ba_stride, kf_cull_stride=cull_stride, force_ba_every=force_ba_every))

    logs = {}
    for name, slam in (("jax", JSLAM(cfg(jcfg), enable_loop_closing=False)),
                       ("torch", TSLAM(cfg(tcfg), enable_loop_closing=False, device="cpu"))):
        log = logs[name] = []
        _mock_programs(slam, name, log)
        slam._n_kf = 1
        for fid, event in enumerate("KKIKKKIIKKKKIK"):
            if event == "K":
                slam._insert_and_map(Cur(None, np.eye(4), np.zeros(4)), fid, {"next_mp": 0})
            elif slam._pending_kf is not None:
                slam._run_deferred_mapping()
        slam.flush()
    assert logs["torch"] == logs["jax"]
    assert any(e[0] == "tail" for e in logs["jax"])


def test_loop_closing_is_refused_when_mapping():
    """Mapping with the loop closer, refused before the loop-closing slice,
    is the default now; ``enable_loop_closing=False`` maps without it, and
    localization mode ignores the flag as before."""
    assert TSLAM(small_cfg(tcfg), device="cpu").enable_loop_closing
    off = TSLAM(small_cfg(tcfg), enable_loop_closing=False, device="cpu")
    assert off._n_kf == 0 and not off.enable_loop_closing
    loc = small_cfg(tcfg)
    assert not TSLAM(loc.replace(tracking=dataclasses.replace(loc.tracking, only_tracking=True)),
                     device="cpu").enable_loop_closing
