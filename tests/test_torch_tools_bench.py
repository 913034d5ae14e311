"""``tools.bench`` (the port of the repository's ``bench.py``) on the CPU
at the 320×192 camera of ``test_torch_tracking.small_cfg``, mapping on.

* The JAX ``SLAM`` maps a forward pass of the default world at 0.35
  m/frame; its last frame, velocity, map, local map and reference keyframe
  are carried to a port ``SLAM`` (``convert.py``).  The return pass is then
  run by a copy of ``bench.py``'s ``jax.lax.scan`` (its body, lines
  208-216) and by ``tools.bench.run_sequence`` on the same images: every
  integer of every frame's host vector equal (the counts, ``n_tracked``,
  ``best_ref_kf``, ``next_mp``, ``n_ref_matches``), the frame's pose and its
  reference keyframe's pose within ``test_torch_pipelined``'s 1 cm / 0.1°.
* The frame program bumps the map's counters in place: a second run from
  the restored map storage gives the same host vectors, and the first run
  changed the storage.
* ``main`` with ``--secondary none``: the headline, detail and gate lines
  with the keys of ``bench.py``'s own (read from its source), in its order
  and streams, then the whole result; the median inliers of this small
  camera fall under the floor of 300, so it exits 1 after its lines.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mapping import rot_deg, two_torch_threads  # noqa: F401  (autouse)
from test_torch_pipelined import POSE_TOL_DEG, POSE_TOL_M
from test_torch_tools_benches import jax_dicts
from test_torch_tools_frontend import small_yaml  # noqa: F401  (fixture)
from test_torch_tracking import small_cfg

import orb_slam2_ros2_tpu.config as jcfg
import orb_slam2_ros2_tpu_torch.config as tcfg
from orb_slam2_ros2_tpu.io.synthetic import SyntheticStereoDataset as JDataset
from orb_slam2_ros2_tpu.pipeline import system as jsys
from orb_slam2_ros2_tpu_torch import convert
from orb_slam2_ros2_tpu_torch.pipeline import system as tsys
from orb_slam2_ros2_tpu_torch.tools import _timing, bench

WARM = 10           # the forward pass
T = 7               # the return pass: frames WARM-2 … WARM-1-T
SPEED = 0.35
NS = len(tsys.STAT_KEYS)


def map_cfg(mod):
    cfg = small_cfg(mod)
    return cfg.replace(tracking=dataclasses.replace(cfg.tracking, only_tracking=False))


def jax_scan(slam, stack_l, stack_r) -> np.ndarray:
    """``bench.py``'s ``run_sequence`` (lines 204-223) over ``slam``'s state."""
    step_fn, cam = slam._frame_fn, slam.cam
    best_ref_idx = jsys.STAT_KEYS.index("best_ref_kf")

    @jax.jit
    def run_sequence(stack_l, stack_r, state, velocity, mapstate, local, ref_kf):
        def body(carry, imgs):
            state, velocity, mapstate, local, ref_kf = carry
            il, ir = imgs
            state, velocity, host_vec, mapstate, local = step_fn(
                cam, il, ir, state, velocity, local, mapstate, ref_kf
            )
            best_ref = host_vec[best_ref_idx].astype(jnp.int32)
            ref_kf = jnp.where(best_ref >= 0, best_ref, ref_kf)
            return (state, velocity, mapstate, local, ref_kf), host_vec

        _, hv = jax.lax.scan(body, (state, velocity, mapstate, local, ref_kf), (stack_l, stack_r))
        return hv

    return np.asarray(run_sequence(stack_l, stack_r, slam.last, slam.velocity, slam.map, slam.local,
                                   jnp.asarray(slam.ref_kf, jnp.int32)))


@pytest.fixture(scope="module")
def world():
    """The JAX SLAM after the forward pass, the return pass's images, JAX's
    host vectors, and a port SLAM holding the JAX SLAM's state."""
    ds = JDataset(map_cfg(jcfg).camera, n_frames=WARM, speed=SPEED)
    frames = [tuple(np.asarray(x) for x in ds.frame(i)[:2]) for i in range(WARM)]
    js = jsys.SLAM(map_cfg(jcfg), enable_loop_closing=False)
    for img_l, img_r in frames:
        assert js.track(img_l, img_r)[0] is not None
    js.flush()
    rev = list(range(WARM - 2, WARM - 2 - T, -1))
    hv_j = jax_scan(js, jnp.stack([frames[i][0] for i in rev]), jnp.stack([frames[i][1] for i in rev]))

    npt = lambda x: jax.tree.map(np.asarray, x)  # noqa: E731
    ts = tsys.SLAM(map_cfg(tcfg), enable_loop_closing=False, device="cpu")
    ts.map = convert.map_state_to_torch(npt(js.map), "cpu")
    ts.last = convert.slam_frame_to_torch(npt(js.last), "cpu")
    ts.velocity = torch.from_numpy(np.array(js.velocity))
    ts.local = convert.local_map_to_torch(npt(js.local), "cpu")
    ts.ref_kf = int(js.ref_kf)
    images = tuple([torch.from_numpy(np.array(frames[i][k])) for i in rev] for k in (0, 1))
    return dict(jax=js, hv_j=hv_j, slam=ts, images=images, n_kf=js.n_keyframes)


@pytest.fixture(scope="module")
def port_runs(world):
    """Two runs of ``run_sequence``, the map storage restored before the
    second; the storage after the first."""
    slam = world["slam"]
    storage = list(slam.map)
    pristine = [t.clone() for t in storage]
    first = bench.run_sequence(slam, *world["images"])
    bumped = [t.clone() for t in storage]
    torch._foreach_copy_(storage, pristine)
    second = bench.run_sequence(slam, *world["images"])
    return dict(first=first, second=second, pristine=pristine, bumped=bumped)


def test_run_sequence_matches_the_jax_scan(world, port_runs):
    hv_j, hv_t = world["hv_j"], port_runs["first"]
    assert world["n_kf"] >= 3 and hv_t.shape == hv_j.shape == (T, NS + 32)
    n_tracked = hv_t[:, tsys.STAT_KEYS.index("n_tracked")]
    assert (n_tracked > 30).all(), n_tracked   # every frame of the return pass tracked
    np.testing.assert_array_equal(hv_t[:, :NS].astype(int), hv_j[:, :NS].astype(int))
    for part in (slice(NS, NS + 16), slice(NS + 16, NS + 32)):
        Tt, Tj = hv_t[:, part].reshape(T, 4, 4), hv_j[:, part].reshape(T, 4, 4)
        assert np.abs(Tt[:, :3, 3] - Tj[:, :3, 3]).max() <= POSE_TOL_M
        assert rot_deg(Tt, Tj).max() <= POSE_TOL_DEG


def test_run_sequence_moves_ref_kf_on_the_device(world, port_runs):
    """The reference keyframe each frame's stats were taken against is the
    one the frame before chose: the host vectors' reference poses follow
    ``best_ref_kf`` (a host int held fixed would not)."""
    hv = port_runs["first"]
    best = hv[:, tsys.STAT_KEYS.index("best_ref_kf")].astype(int)
    kf_Tcw = world["slam"].map.kf_Tcw.numpy()
    refs = [world["slam"].ref_kf] + [b if b >= 0 else None for b in best[:-1]]
    for i in range(T):
        refs[i] = refs[i] if refs[i] is not None else refs[i - 1]
        np.testing.assert_array_equal(hv[i, NS + 16:NS + 32].reshape(4, 4), kf_Tcw[refs[i]])
    assert len(set(refs)) > 1, refs   # the reference keyframe moved during the pass


def test_restored_storage_repeats_the_run(port_runs):
    np.testing.assert_array_equal(port_runs["second"], port_runs["first"])
    changed = [not torch.equal(a, b) for a, b in zip(port_runs["bumped"], port_runs["pristine"])]
    assert any(changed)   # the counters were bumped in place


def test_main_prints_jax_lines_and_exits_1_under_the_floor(small_yaml, capsys):  # noqa: F811
    with pytest.raises(_timing.Failed) as e:
        bench.main(["--device", "cpu", "--config", small_yaml, "--warm", "8", "--frames", "5", "--reps", "1",
                    "--secondary", "none"])
    assert e.value.code == 1
    out = e.value.result
    cap = capsys.readouterr()
    stdout = [json.loads(x) for x in cap.out.strip().splitlines()]
    stderr = [json.loads(x) for x in cap.err.strip().splitlines() if x.startswith("{")]
    keys = jax_dicts("bench.py")
    headline = next(k for k in keys if "vs_baseline" in k)
    detail = next(k for k in keys if "detail" in k)["detail"]
    gate = next(k for k in keys if "median_inliers_floor" in k)
    assert list(headline) == ["metric", "value", "unit", "vs_baseline"]
    assert list(stdout[0]) == [*headline, "card"] and stdout[0]["metric"] == "kitti_size_stereo_tracking_fps"
    assert [list(x)[0] for x in stderr] == ["detail", "quality_gate"]
    assert set(detail) <= set(stderr[0]["detail"]) and set(gate) == set(stderr[1]["quality_gate"])
    assert stdout[-1] == out and all(x["card"] == "cpu" for x in stdout + stderr)
    assert out["quality_gate"]["pass"] is False and out["exit_code"] == 1 and out["full_slam"] is None
    d = out["detail"]
    assert d["n_frames"] == 5 and d["tracked"] == 8 and d["median_inliers"] < bench.INLIER_FLOOR
    assert out["value"] > 0 and d["local_ba_ms_per_kf"] > 0 and len(d["rep_ms_per_frame"]) == 1
