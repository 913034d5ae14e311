"""The frontend measurement tools (``orb_slam2_ros2_tpu_torch.tools``:
``profile_scan``, ``profile_extract``, ``profile_trace``, ``bench_micro``)
run on the CPU at the 320×192 camera of ``test_torch_tracking.small_cfg``
with two frames a pass and one pass: each returns its keys, every time
finite and positive.  Also: every tool refuses to run without a card unless
given ``--device cpu``, and the tools import nothing of the tests or of the
JAX package.  (On the CPU the kernel wrappers run their plain twins; CPU
times are not measurements.)
"""

import importlib
import math
import os

import pytest
import yaml
from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)

import orb_slam2_ros2_tpu_torch.tools as tools

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(
    camera=dict(fx=200.0, fy=200.0, cx=160.0, cy=96.0, baseline=0.5, width=320, height=192),
    orb=dict(n_features=500, max_keypoints=512),
    tracking=dict(min_init_depth_kps=150, max_local_mappoints=4096, max_local_keyframes=16),
    map=dict(max_keyframes=64, max_mappoints=16384, max_obs_per_mp=16),
)


@pytest.fixture(scope="module")
def small_yaml(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "small.yaml"
    path.write_text(yaml.safe_dump(SMALL))
    return str(path)


def run(name, *argv):
    return importlib.import_module(f"orb_slam2_ros2_tpu_torch.tools.{name}").main(["--device", "cpu", *argv])


def times_ok(ms: dict) -> bool:
    return all(math.isfinite(v) and v > 0 for v in ms.values())


@pytest.mark.parametrize("name", tools.TOOLS)
def test_each_tool_needs_a_card_or_device_cpu(name):
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    mod = importlib.import_module(f"orb_slam2_ros2_tpu_torch.tools.{name}")
    with pytest.raises(RuntimeError, match="--device cpu"):
        mod.main([])


def test_tools_import_no_test_module():
    """No tool imports a test module, the JAX package or a JAX root script."""
    bad = []
    folder = os.path.join(ROOT, "orb_slam2_ros2_tpu_torch", "tools")
    roots = {f[:-3] for f in os.listdir(ROOT) if f.endswith(".py")}
    for f in sorted(os.listdir(folder)):
        if f.endswith(".py"):
            for line in open(os.path.join(folder, f)):
                s = line.strip()
                if s.startswith(("import ", "from ")) and (
                        "test" in s or "jax" in s or s.split()[1].split(".")[0] in roots):
                    bad.append((f, s))
    assert not bad, bad
    assert set(tools.TOOLS) == {f[:-3] for f in os.listdir(folder) if not f.startswith("_") and f.endswith(".py")}


def test_profile_scan(small_yaml):
    out = run("profile_scan", "--config", small_yaml, "--frames", "2", "--reps", "1")
    assert list(out["ms_per_frame"]) == ["A_pyramid", "B_fast_nms", "C_extract", "D_frontend", "E_odometry"]
    assert times_ok(out["ms_per_frame"]) and set(out["delta_ms"]) == set(out["ms_per_frame"])
    assert out["card"] == "cpu"


def test_profile_extract(small_yaml):
    out = run("profile_extract", "--config", small_yaml, "--frames", "2", "--reps", "1")
    assert list(out["ms_per_frame"]) == ["S1_select", "S2_centers", "S3_patches", "S4_orientations",
                                         "S5_describe"]
    assert times_ok(out["ms_per_frame"])


def test_profile_trace(small_yaml, tmp_path):
    out = run("profile_trace", "--config", small_yaml, "--frames", "2", "--out", str(tmp_path))
    assert out["replays"] == 2 and len(out["sessions"]) == 1
    assert (tmp_path / "op_stats.csv").read_text().startswith("name,calls,total_us,mean_us")


def test_bench_micro():
    out = run("bench_micro", "--frames", "2", "--reps", "1", "--height", "96", "--width", "160")
    assert set(out["ms_per_frame"]) == {
        "fast_nms_k1_canvas", "fast_nms_k1_per_level", "fast_nms_plain_twin", "pyramid_matmul_batched",
        "pyramid_matmul_2x_single", "pyramid_interpolate_2x", "select_batched", "select_2x_loop"}
    assert times_ok(out["ms_per_frame"]) and out["shape"] == [2, 96, 160]
