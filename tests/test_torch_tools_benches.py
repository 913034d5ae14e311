"""``tools.bench_full`` and ``tools.bench_loop`` (the ports of the
repository's ``bench_full.py`` and ``bench_loop.py``) on the CPU at the
320×192 camera of ``test_torch_tracking.small_cfg``:

* each tool's lines carry the keys of the JAX script's (read from its
  source with ``ast``: importing a root script would point JAX's compile
  cache elsewhere);
* ``bench_loop.spike_stats`` is JAX's arithmetic (``bench_loop.py:73-90``)
  on one frame-time array, and ``lap_frames`` JAX's two-lap index map (its
  formula read from the source and evaluated);
* a few-frame ``bench_full`` run: its live and final ATE, path length and
  gate equal JAX's ``ate_rmse`` and gate on the same trajectories, and the
  run exits 1 exactly when the gate fails;
* a circle too short to close prints JAX's ``"no loop closed"`` line.
"""

import ast
import os
import re

import numpy as np
import pytest
from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)
from test_torch_tools_frontend import ROOT, small_yaml  # noqa: F401  (fixture)

from orb_slam2_ros2_tpu.io.trajectory import ate_rmse as jax_ate_rmse
from orb_slam2_ros2_tpu_torch.tools import _timing, bench_full, bench_loop


def jax_dicts(script: str) -> list:
    """Every dict literal of the root ``script`` whose keys are strings, as
    {key: the keys of a dict-literal value (the same form), else None}, in
    source order."""

    def keys(node):
        if not isinstance(node, ast.Dict) or not all(
                isinstance(k, ast.Constant) and isinstance(k.value, str) for k in node.keys):
            return None
        return {k.value: keys(v) for k, v in zip(node.keys, node.values)}

    tree = ast.parse(open(os.path.join(ROOT, script)).read())
    return [d for d in (keys(n) for n in ast.walk(tree)) if d]


def _source(script: str) -> str:
    return open(os.path.join(ROOT, script)).read()


# ------------------------------------------------------------ bench_loop --

def test_lap_frames_is_jax_index_map():
    formula = re.search(r"^\s*j = (.+)$", _source("bench_loop.py"), re.M).group(1)
    for n in (12, 100):
        want = [eval(formula, {}, dict(i=i, N=n, period=n - 4)) for i in range(2 * (n - 4))]
        assert bench_loop.lap_frames(n) == want
    frames = bench_loop.lap_frames(100)
    assert len(frames) == 192 and frames[:100] == list(range(100)) and frames[100] == 4


def test_spike_stats_is_jax_arithmetic():
    ft = np.random.default_rng(5).lognormal(3.3, 0.4, 160)
    closures = [97, 140]
    got = bench_loop.spike_stats(ft, closures)
    # bench_loop.py:73-90
    med = float(np.median(ft[10:]))
    last = closures[-1]
    post = ft[last:]
    first_post = ft[closures[0]:closures[0] + 20]
    want = {"value": float(post.max()) / med, "median_frame_ms": med,
            "max_after_last_closure_ms": float(post.max()),
            "p99_after_last_closure_ms": float(np.percentile(post, 99)),
            "first_closure_max_ms": float(first_post.max())}
    d = got["detail"]
    assert got["value"] == want["value"] and round(got["value"], 2) == round(float(post.max()) / med, 2)
    for k in want:
        if k != "value":
            assert d[k] == want[k], k
    assert d["closures"] == closures and d["frames"] == 160
    spike = next(k for k in jax_dicts("bench_loop.py") if isinstance(k.get("detail"), dict))
    assert list(got) == list(spike) and set(spike["detail"]) - {"device"} == set(d)


def test_bench_loop_without_a_closure_prints_jax_line(small_yaml):  # noqa: F811
    out = bench_loop.main(["--device", "cpu", "--config", small_yaml, "--frames", "12"])
    none_line = next(k for k in jax_dicts("bench_loop.py") if "detail" in k and k["detail"] is None)
    assert list(none_line) == ["metric", "value", "detail"]
    assert {k: out[k] for k in none_line} == {"metric": "post_loop_frame_spike", "value": None,
                                              "detail": "no loop closed"}
    assert '"no loop closed"' in _source("bench_loop.py") and out["card"] == "cpu"


# ------------------------------------------------------------ bench_full --

@pytest.fixture(scope="module")
def full_run(small_yaml):  # noqa: F811
    """A 4 + 4 frame run; the trajectories and ground truth its gate saw."""
    seen = {}
    gate = bench_full.ate_gate

    def spy(slam, gt):
        seen.update(live=list(slam.trajectory), final=slam.final_trajectory(), gt=dict(gt))
        return gate(slam, gt)

    bench_full.ate_gate = spy
    try:
        argv = ["--device", "cpu", "--config", small_yaml, "--warm", "4", "--frames", "4"]
        out, failed = bench_full.main(argv), False
    except _timing.Failed as e:
        out, failed = e.result, True
    finally:
        bench_full.ate_gate = gate
    return out, failed, seen


def test_bench_full_keys(full_run):
    out, _, _ = full_run
    line = next(k for k in jax_dicts("bench_full.py") if "metric" in k)
    assert list(line) == ["metric", "value", "unit", "detail"]
    assert set(line) <= set(out)
    assert out["metric"] == "kitti_size_full_slam_fps" and out["value"] > 0 and out["card"] == "cpu"
    assert set(line["detail"]) <= set(out["detail"])
    d = out["detail"]
    assert d["n_frames"] == 4 and d["tracked"] == 4 and d["tunnel_rtt_ms"] > 0 and d["ba_window"] == [8, 16, 3072]


def test_bench_full_ate_gate_is_jax(full_run):
    """``bench_full.py:135-157`` with the JAX package's ``ate_rmse`` on the
    trajectories the port's run gated."""
    out, failed, seen = full_run
    gt_twc = seen["gt"]

    def _ate(pairs):
        est = [np.linalg.inv(T) for f, T in pairs if f in gt_twc]
        gt = [gt_twc[f] for f, _T in pairs if f in gt_twc]
        return jax_ate_rmse(est, gt) if len(est) >= 3 else float("nan")

    ate_live, ate_final = _ate(seen["live"]), _ate(seen["final"])
    fids = sorted(f for f, _ in seen["live"] if f in gt_twc)
    path_len = float(sum(np.linalg.norm(gt_twc[b][:3, 3] - gt_twc[a][:3, 3]) for a, b in zip(fids, fids[1:])))
    ok = bool(path_len > 0 and ate_live < 0.05 * path_len and ate_final < 0.03 * path_len)
    d = out["detail"]
    assert len(seen["live"]) == 8 and np.isfinite(ate_live) and np.isfinite(ate_final)
    np.testing.assert_allclose([d["ate_live_m"], d["ate_final_m"], d["path_len_m"]],
                               [ate_live, ate_final, path_len], rtol=1e-9)
    assert d["ate_gate_pass"] is ok and failed is (not ok)
