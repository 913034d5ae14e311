"""``tools/bench_io.py`` against the repository's ``bench_io.py``, on the
CPU: the port's ``build_state`` equals JAX's field by field (descriptor
words compared as int32 bits), the ``.pb`` bytes and the txt files the
port writes for that state equal JAX's, and ``main`` returns its keys with
every format's load equal to the saved state.  (Importing the root script
only sets ``jax_platforms`` to the CPU, which the suite already does.)
"""

import numpy as np
import pytest
from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)

import bench_io as jbench
import orb_slam2_ros2_tpu.config as jcfg
from orb_slam2_ros2_tpu.io import proto_map as jpm
from orb_slam2_ros2_tpu.io import txt_map as jtm
from orb_slam2_ros2_tpu_torch.io import proto_map as tpm
from orb_slam2_ros2_tpu_torch.io import txt_map as ttm
from orb_slam2_ros2_tpu_torch.mapstate.map_state import MapState
from orb_slam2_ros2_tpu_torch.tools import bench_io


def jax_config():
    """The configuration of ``bench_io.main`` (``bench_io.py:117-120``)."""
    return jcfg.SLAMConfig(orb=jcfg.ORBConfig(max_keypoints=512),
                           map=jcfg.MapConfig(max_keyframes=64, max_mappoints=8192, max_obs_per_mp=12))


@pytest.fixture(scope="module")
def states():
    return jbench.build_state(jax_config()), bench_io.build_state(bench_io.bench_config(), device="cpu")


def test_config_is_the_jax_scripts():
    import dataclasses

    from test_torch_frontend import jax_defaults

    assert dataclasses.asdict(bench_io.bench_config()) == jax_defaults(jax_config())


def test_build_state_matches_jax(states):
    js, ts = states
    for f in MapState._fields:
        want = np.asarray(getattr(js, f))
        if want.dtype == np.uint32:
            want = want.view(np.int32)
        got = getattr(ts, f).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("fmt", ["pb", "txt"])
def test_written_bytes_equal_jax(states, fmt, tmp_path):
    js, ts = states
    if fmt == "pb":
        jpm.save_proto_map(str(tmp_path / "j.pb"), js, jax_config())
        tpm.save_proto_map(str(tmp_path / "t.pb"), ts, bench_io.bench_config())
        a, b = (tmp_path / "j.pb").read_bytes(), (tmp_path / "t.pb").read_bytes()
        assert a == b and len(a) > 100_000
        return
    jtm.save_txt_map(str(tmp_path / "j"), js, jax_config())
    ttm.save_txt_map(str(tmp_path / "t"), ts, bench_io.bench_config())
    for name in ("KeyFrames.txt", "MapPoints.txt"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name


def test_main_returns_its_keys():
    out = bench_io.main(["--device", "cpu"])
    assert set(out["formats"]) == {"npz", "proto", "txt"}
    for name, r in out["formats"].items():
        assert r["load_equal"] is True, name
        assert r["save_ms"] > 0 and r["load_ms"] > 0 and r["bytes"] > 0
    assert out["max_kf_translation"] == pytest.approx(0.4 * 47, abs=1e-5)
    assert out["proto_vs_txt_size"] < 1.0


def test_load_equal_sees_a_changed_field(states):
    _, ts = states
    moved = ts._replace(mp_pos=ts.mp_pos + 1e-3)
    assert not bench_io.load_equal(ts, moved, "proto", 48, 4000)
    assert not bench_io.load_equal(ts, moved, "npz", 48, 4000)
    assert bench_io.load_equal(ts, ts._replace(mp_pos=ts.mp_pos.clone()), "npz", 48, 4000)
