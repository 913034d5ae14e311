"""The harness on the CPU: discovery of configurations, traffic mixes and
metrics by new files alone (in a temporary copy of the benchmark), the
window's accounting, the import check, a tiny run of each cell's route
through ``SLAM.track()`` against the reference, and the comparison failing
under the fp8 control and under faults planted in the timed path.

The harness's look for a card is skipped: ``run_cell`` is driven with
``device="cpu"`` at tiny sizes.  Run from the repository's root:
``python -m pytest slambench/tests -q``."""

from __future__ import annotations

import json
import re
import shutil
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from slambench import harness
from slambench.faults import FAULTS
from slambench.run import forbidden_modules

REPO = Path(__file__).resolve().parents[2]
WINDOW_S = 4.0

TINY_SLAM = {
    "orb": {"n_features": 500, "max_keypoints": 512},
    "tracking": {"min_init_depth_kps": 120, "max_local_mappoints": 4096, "max_local_keyframes": 16,
                 "min_localmap_matches": 20, "min_localmap_inliers": 20, "pipelined": True},
    "map": {"max_keyframes": 32, "max_mappoints": 8192, "max_obs_per_mp": 12},
    "bow": {"branching": 4, "depth": 2},
    "ba": {"pcg_iters": 15},
}
STEREO_CAM = {"fx": 200.0, "fy": 200.0, "cx": 160.0, "cy": 96.0, "baseline": 0.5, "width": 320, "height": 192}
RGBD_CAM = {"fx": 200.0, "fy": 200.0, "cx": 160.0, "cy": 96.0, "baseline": 0.08, "width": 320, "height": 192,
            "k1": 0.231222, "k2": -0.784899, "p1": -0.003257, "p2": -0.000105, "k3": 0.917205,
            "camera_type": 1, "color": 1, "depth_scale": 5208.0}
DUMMY_METRIC = '''"""Frames done in the window (a metric added by a file alone)."""


def read(rec):
    return float(rec["frames_done"])
'''


def _add_config(root: Path, name: str, base: str, camera: dict, rgbd: bool):
    c = json.loads((REPO / "slambench" / "configs" / f"{base}.json").read_text())
    c.update(name=name, rgbd=rgbd, slam=dict(TINY_SLAM, camera=camera))
    c["check"]["sample_keyframes"] = 3
    (root / "slambench" / "configs" / f"{name}.json").write_text(json.dumps(c))


def _add_mix(root: Path, name: str, base: str, world=None, route=None):
    t = json.loads((REPO / "slambench" / "traffic" / f"{base}.json").read_text())
    t.update(name=name, warm_frames=4, warm_keyframes=2, warm_max_frames=8, ceiling_frames_per_s=10, trace_frames=[1, 3])
    t["world"].update(world or {})
    t["route"].update(route or {})
    (root / "slambench" / "traffic" / f"{name}.json").write_text(json.dumps(t))


@pytest.fixture(scope="module")
def root(tmp_path_factory) -> Path:
    """A copy of the benchmark with tiny configurations, mixes and cells,
    and one more per-layer metric, each added as a file and an entry."""
    r = tmp_path_factory.mktemp("bench")
    shutil.copy(REPO / "BENCHMARK.json", r / "BENCHMARK.json")
    shutil.copytree(REPO / "slambench", r / "slambench", ignore=shutil.ignore_patterns("__pycache__"))
    _add_config(r, "tiny_stereo", "kitti00_stereo", STEREO_CAM, False)
    _add_config(r, "tiny_rgbd", "tum_fr2_rgbd", RGBD_CAM, True)
    _add_mix(r, "tiny_drive", "drive", world={"box_scale": 1.0, "sky": False}, route={"speed_m": 0.55})
    _add_mix(r, "tiny_handheld", "handheld", route={"speed_m": 0.04, "mean_turn_deg": 0.5})
    _add_mix(r, "tiny_circuits", "drive", world={"box_scale": 1.0, "sky": False},
             route={"kind": "circuits", "speed_m": 0.4, "turn_speed_m": 0.3, "radius_m": 3.0,
                    "first_straight_m": 0.8, "straight_m": 2.0, "start": [-3.0, 0.0, 0.0]})
    (r / "slambench" / "metrics" / "tiny_frames_done.py").write_text(DUMMY_METRIC)
    b = json.loads((r / "BENCHMARK.json").read_text())
    b["configs"] += [{"name": n, "source": "a test", "file": f"slambench/configs/{n}.json", "reduced": [],
                      "why": "test"} for n in ("tiny_stereo", "tiny_rgbd")]
    b["workloads"] += [{"name": f"tiny.{m}", "config": c, "traffic": f"tiny_{m}", "chips": 1, "why": "test"}
                       for m, c in (("drive", "tiny_stereo"), ("handheld", "tiny_rgbd"),
                                    ("circuits", "tiny_stereo"))]
    b["per_layer"].append({"name": "tiny_frames_done", "unit": "frames", "better": "higher",
                           "source": "host_clock", "layer": "test", "moves": "frames_per_s",
                           "workloads": ["tiny.drive"]})
    (r / "BENCHMARK.json").write_text(json.dumps(b))
    return r


def _run(root, cell, *, trace=False, seed=2**31 + 9, **kw):
    return harness.run_cell(harness.load_cell(root, cell), seed=seed, seconds=WINDOW_S, trace=trace,
                            device="cpu", t_start=time.perf_counter(), **kw)


def test_forbidden_modules_by_whole_top_level_name():
    mods = {"jax.numpy": 0, "orb_slam2_ros2_tpu_torch.ops": 0, "orb_slam2_ros2_tpu.io": 0, "jaxlib": 0,
            "flaxen": 0, "numpy": 0}
    assert forbidden_modules(mods) == ["jax", "jaxlib", "orb_slam2_ros2_tpu"]
    assert forbidden_modules({"orb_slam2_ros2_tpu_torch": 0, "jaxtyping": 0}) == []


def test_the_yardstick_imports_nothing_of_the_port_or_jax():
    """The generator, the reference, the timing helpers, the work counts and
    the metric readers import neither JAX, nor the JAX package, nor the
    port; the harness and the fault plants import the port (the system
    under test) and nothing of JAX."""
    pattern = re.compile(r"^\s*(?:from|import)\s+(jax|jaxlib|flax|orb_slam2_ros2_tpu\w*)\b", re.M)
    for path in (REPO / "slambench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        found = set(pattern.findall(path.read_text()))
        allowed = {"orb_slam2_ros2_tpu_torch"} if path.name in ("harness.py", "faults.py") else set()
        assert found <= allowed, (path, found)


def test_new_files_add_a_config_a_mix_a_cell_and_a_metric(root):
    out = _run(root, "tiny.drive")
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"frames_per_s", "setup_s"}
    traced = _run(root, "tiny.drive", trace=True, seed=5)
    assert traced["metrics"]["tiny_frames_done"]["value"] >= 1
    assert "tiny_frames_done" not in _run_loaded_names(root, "tiny.circuits")


def _run_loaded_names(root, cell):
    return set(harness.load_cell(root, cell)["metrics"])


@pytest.mark.parametrize("cell", ["tiny.handheld", "tiny.circuits"])
def test_each_route_tracks_against_the_reference(root, cell):
    out = _run(root, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["checks"]["kp_mismatch_pct"]["value"] == 0.0


def test_the_fp8_control_fails(root):
    out = _run(root, "tiny.drive", control="fp8", seed=11)
    assert not out["correct"]
    assert out["checks"]["kp_mismatch_pct"]["value"] > out["checks"]["kp_mismatch_pct"]["limit"]


@pytest.mark.parametrize("cell", ["tiny.drive", "tiny.handheld"])
@pytest.mark.parametrize("kind", sorted(FAULTS))
def test_a_fault_in_the_timed_path_is_not_correct(root, kind, cell):
    """Each fault planted under the harness (``slambench.faults``): the
    frontend's three, local BA skipped or its poses put back, tracking's
    pose optimisations returning their input."""
    out = _run(root, cell, fault=FAULTS[kind], seed=13)
    assert not out["correct"], out["checks"]


class _StubSLAM:
    """A pipelined system that takes 10 ms a call, delivers frame N's pose on
    call N+1, and loses frame ``LOST``."""

    LOST = 9

    def __init__(self, cfg, rgbd=False, device="cpu"):
        none = SimpleNamespace(captures=0)
        self._frame_graphs, self._kf_graphs, self._gba_graphs, self._reloc_graph = None, none, none, none
        self.loop_closer, self._n_kf, self.loops_closed = None, 0, 0
        self.map = SimpleNamespace(kf_valid=torch.zeros(2, dtype=torch.bool),
                                   kf_frame_id=torch.zeros(2, dtype=torch.int32), kf_capacity=2, mp_capacity=2)
        self.trajectory, self.program_events, self.time_programs = [], [], False
        self.fid, self.pending = 0, None

    def _resolve(self):
        prev, self.pending = self.pending, None
        if prev is None:
            return None, {"pipeline_fill": True}
        if prev == self.LOST:
            return None, {}
        self.trajectory.append((prev, np.eye(4, dtype=np.float32)))
        return np.eye(4), {}

    def track(self, a, b):
        time.sleep(0.01)
        prev = self._resolve()
        self.pending, self.fid = self.fid, self.fid + 1
        return prev

    def flush(self):
        self._resolve()

    def final_trajectory(self):
        return list(self.trajectory)


def test_window_accounting(root, monkeypatch):
    from orb_slam2_ros2_tpu_torch.pipeline import system

    monkeypatch.setattr(system, "SLAM", _StubSLAM)
    loaded = harness.load_cell(root, "tiny.drive")
    loaded["traffic"]["ceiling_frames_per_s"] = 400
    out = harness.run_cell(loaded, seed=1, seconds=0.5, trace=False, device="cpu", t_start=time.perf_counter())
    info = out["info"]
    assert out["failed"] == 1                                    # the LOST frame: attempted and failed
    assert out["attempted"] == info["frames_done"] + 1
    assert info["in_flight_at_close"] == 1                       # its pose not back: not counted
    assert info["latency_samples"] == info["frames_done"] == info["frames_handed"] - 2
    fps = out["metrics"]["frames_per_s"]["value"]
    assert fps == pytest.approx(info["frames_done"] / info["window_s"])
    assert 9.0 <= info["latency_ms_pcts"]["95"] <= 60.0                     # one 10 ms call a frame


def _scene(n_kf=4, n_pts=60, seed=0):
    """Keyframes along z looking at points 5-9 m ahead, with the exact
    stereo keypoints of each point in each keyframe."""
    from slambench.reference import mapping

    g = torch.Generator().manual_seed(seed)
    cam = dict(STEREO_CAM)
    pts = torch.cat([torch.rand(n_pts, 2, generator=g, dtype=torch.float64) * 4 - 2,
                     5 + 4 * torch.rand(n_pts, 1, generator=g, dtype=torch.float64)], 1)
    Tcw = torch.eye(4, dtype=torch.float64).repeat(n_kf, 1, 1)
    Tcw[:, 0, 3] = -0.3 * torch.arange(n_kf, dtype=torch.float64)
    _, pred = mapping._project(Tcw[:, None], pts[None].expand(n_kf, -1, -1), cam)
    return cam, pts, Tcw, pred


def _judge(cam, pts, Tcw, pred, kf_Tcw0):
    from slambench.reference import mapping

    n_kf, n_pts = pred.shape[:2]
    octave = torch.zeros(n_pts, dtype=torch.int32)
    ref = dict(valid=torch.ones(n_pts, dtype=torch.bool), uv=pred[0, :, :2], right_u=pred[0, :, 2], octave=octave)
    sample = dict(kf_Tcw=kf_Tcw0, mp_pos=pts, mp_ok=torch.ones(n_pts, dtype=torch.bool),
                  mp_idx=torch.arange(n_pts))
    points = dict(ids=torch.arange(n_pts), pos=pts, valid=torch.ones(n_pts, n_kf, dtype=torch.bool),
                  Tcw=Tcw[None].expand(n_pts, -1, -1, -1), uv=pred.transpose(0, 1)[..., :2],
                  right_u=pred.transpose(0, 1)[..., 2], octave=torch.zeros(n_pts, n_kf, dtype=torch.int32))
    return mapping.judge([sample], [ref], points, cam, 1.2, 5.991, 7.815)


def test_the_mapping_reference_leaves_an_adjusted_map_alone_and_finds_a_bad_one():
    """Exact points and poses: nothing to remove.  Points off by ~5 cm or a
    pose off by 2 cm: the reference's solves remove most of the cost."""
    cam, pts, Tcw, pred = _scene()
    exact = _judge(cam, pts, Tcw, pred, Tcw[0])
    assert exact["map_point_gain_med_pct"] < 1e-6
    g = torch.Generator().manual_seed(1)
    noisy = pts + 0.05 * torch.randn(pts.shape, generator=g, dtype=torch.float64)
    out = _judge(cam, noisy, Tcw, pred, Tcw[0])
    assert out["map_point_gain_med_pct"] > 50.0
    moved = Tcw[0].clone()
    moved[:3, 3] += torch.tensor([0.02, -0.01, 0.0], dtype=torch.float64)
    out = _judge(cam, pts, Tcw, pred, moved)
    assert out["map_pose_gain_pct"] > 50.0


def test_the_trace_reduction_over_the_marked_slice():
    """Two marker kernels bound the slice; busy time is the union of the
    device's operations inside it; the idle gaps carry the host span the
    host was in, through the first marker's launch."""
    from torch.autograd import DeviceType

    from slambench import timing

    def ev(dev, name, a, b):
        return SimpleNamespace(device_type=DeviceType.CUDA if dev else DeviceType.CPU, name=name,
                               time_range=SimpleNamespace(start=a, end=b))

    events = [ev(False, "cudaLaunchKernel", 100.0, 101.0),          # the first marker's launch
              ev(True, "at::cuda::spin_kernel(long)", 110.0, 111.0),
              ev(True, "gemm", 111.0, 140.0), ev(True, "copy", 130.0, 150.0),
              ev(True, "gemm", 200.0, 240.0),
              ev(True, "at::cuda::spin_kernel(long)", 300.0, 301.0),
              ev(True, "late", 400.0, 500.0)]
    prof = SimpleNamespace(events=lambda: events)
    base = 5_000_000                                                 # the host's ns at the first marker
    spans = [(base + 20_000, base + 80_000, "track"), (base + 150_000, base + 190_000, "prepare")]
    out = timing.reduce_trace(prof, [base], spans)
    assert out["trace_window_s"] == pytest.approx(191e-6)
    assert out["busy_s"] == pytest.approx((39 + 40) * 1e-6)
    assert out["idle_gaps"][0] == ["prepare", pytest.approx(61e-6)]  # 240-301: the host preparing a frame
    assert out["idle_gaps"][1] == ["track", pytest.approx(50e-6)]    # 150-200: the host inside track()
    assert out["kernels"]["gemm"] == (2, pytest.approx(69.0))
