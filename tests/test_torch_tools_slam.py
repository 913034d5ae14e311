"""The measurement tools that drive a SLAM (``profile_frame``,
``profile_full``, ``profile_loop``, ``profile_kf``, ``profile_ba``) on the
CPU at the 320×192 camera of ``test_torch_tracking.small_cfg``, at a few
frames: each returns its keys, every time finite and positive, every frame
tracked; ``profile_frame``'s stages are the JAX script's, in its order.
(CPU times are not measurements.)
"""

import math
import os
import re

from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)
from test_torch_tools_frontend import ROOT, run, small_yaml, times_ok  # noqa: F401  (fixture)


def jax_frame_stages() -> list:
    """The stage labels of the repository's ``profile_frame.py``, read from
    its source (importing it would point JAX's compile cache elsewhere)."""
    src = open(os.path.join(ROOT, "profile_frame.py")).read()
    loop = re.search(r"for stage in \(([^)]*)\)", src).group(1)
    keys = re.findall(r'results\["([^"]+)"\]', src)
    return keys[:1] + re.findall(r'"([^"]+)"', loop) + keys[1:]


def program_times_ok(programs: dict) -> bool:
    return all(math.isfinite(v) and v > 0 for p in programs.values() for v in p.values())


def test_profile_frame(small_yaml):  # noqa: F811
    out = run("profile_frame", "--config", small_yaml, "--frames", "2", "--warm", "4", "--reps", "1")
    assert jax_frame_stages() == ["frontend", "match1", "opt1", "match2", "vis", "opt2", "full", "frame",
                                  "frame+snap"]
    assert list(out["ms_per_frame"]) == jax_frame_stages() == list(out["delta_ms"])
    assert times_ok(out["ms_per_frame"]) and out["tracked"] == 4


def test_profile_full(small_yaml):  # noqa: F811
    out = run("profile_full", "--config", small_yaml, "--frames", "3", "--warm", "2")
    assert out["tracked"] == out["total_frames"] == 5
    assert {"track", "map_front"} <= set(out["stages"]) and out["fps"] > 0
    assert all(s["n"] > 0 and s["total"] > 0 for s in out["stages"].values())


def test_profile_loop(small_yaml):  # noqa: F811
    out = run("profile_loop", "--config", small_yaml, "--frames", "3", "--warm", "2")
    assert out["tracked"] == out["total_frames"] == 5
    assert sum(c["n"] for c in out["classes"].values()) == 3 and out["all_mean_ms"] > 0


def test_profile_kf(small_yaml):  # noqa: F811
    out = run("profile_kf", "--config", small_yaml, "--warm", "4", "--reps", "1")
    assert set(out["programs"]) == {"map_front", "map_tail", "insert_keyframe", "cull_mappoints", "triangulate",
                                    "fuse_fwd", "fuse_bwd", "snapshot_kf", "snapshot_frame", "local_ba",
                                    "cull_keyframes", "loop_add_detect", "gba_chunk", "gba_commit"}
    assert program_times_ok(out["programs"]) and out["tracked"] == 4


def test_profile_ba(small_yaml):  # noqa: F811
    out = run("profile_ba", "--config", small_yaml, "--warm", "4", "--reps", "1")
    assert set(out["programs"]) == {"extract_window", "solve_ba_points", "local_ba", "topk_M_8192_i32",
                                    "vocab_transform", "sparse_bow"}
    assert program_times_ok(out["programs"]) and out["n_words"] == 10 ** 5
    assert "approx_max_k_M_8192" in out["absent"]
