"""The port's command line against the JAX package's, on the CPU: the
``kitti`` subcommand of both CLIs on one 12-frame KITTI odometry layout
written to disk from the JAX renderer (image_0/ image_1/ times.txt
poses.txt, 320×192 with the configuration of ``tests/test_cli_e2e.py``),
then the port's ``--pipelined`` run against the JAX test's gates, its
``--trace``, its refusal of the multi-GPU flags and ``python -m``.

Against the JAX CLI: equal ``frames``, ``tracked`` and ``keyframes``, the
same JSON keys and ``mappoints`` within 3%; every row of the KITTI
trajectory file within 2 cm / 0.2° and the TUM file's stamps equal.  The
tolerance is twice that of the 10-frame mapping parity tests
(``tests/test_torch_mapping_slice.py``): at 0.55 m/frame with a keyframe
every frame, the two mapping runs part at f32 rounding in local BA, by
4 mm at frame 6 and 1.6 cm / 0.11° at frame 10 of this layout, with loop
closing on or off alike."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from test_cli_e2e import CFG_YAML, _write_kitti_layout
from test_torch_mapping import rot_deg
from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)

from orb_slam2_ros2_tpu import cli as jcli
from orb_slam2_ros2_tpu_torch import cli as tcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 12
SPEED = 0.55          # m/frame of the layout (tests/test_cli_e2e.py)
POSE_TOL_M, POSE_TOL_DEG = 2e-2, 0.2
MP_REL_TOL = 0.03


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    _write_kitti_layout(str(root / "00"), N)
    (root / "cfg.yaml").write_text(CFG_YAML.format(cam_type=0))
    return root


def run(cli, argv, capsys) -> dict:
    cli.main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def kitti_args(layout, out, *extra):
    return ["kitti", "--seq", str(layout / "00"), "--config", str(layout / "cfg.yaml"),
            "--out", str(out), *extra]


def rows_as_poses(path):
    rows = np.loadtxt(path)
    T = np.tile(np.eye(4), (len(rows), 1, 1))
    T[:, :3, :4] = rows.reshape(-1, 3, 4)
    return T


def test_kitti_matches_jax(layout, tmp_path, capsys, monkeypatch):
    # the JAX CLI points jax's compile cache at this directory: keep the suite's
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", jax.config.jax_compilation_cache_dir)
    j = run(jcli, kitti_args(layout, tmp_path / "j"), capsys)
    t = run(tcli, kitti_args(layout, tmp_path / "t", "--device", "cpu"), capsys)
    assert sorted(t) == sorted(j)
    assert (t["frames"], t["tracked"], t["keyframes"]) == (j["frames"], j["tracked"], j["keyframes"]) \
        == (N, N, j["keyframes"])
    assert j["keyframes"] >= 4 and t["ate_rmse"] < 0.05 * N * SPEED
    assert abs(t["mappoints"] - j["mappoints"]) <= MP_REL_TOL * j["mappoints"]
    Tt, Tj = rows_as_poses(f"{tmp_path}/t.kitti.txt"), rows_as_poses(f"{tmp_path}/j.kitti.txt")
    assert Tt.shape == Tj.shape == (N, 4, 4)
    assert np.abs(Tt[:, :3, 3] - Tj[:, :3, 3]).max() <= POSE_TOL_M
    assert rot_deg(Tt, Tj).max() <= POSE_TOL_DEG
    st, sj = np.loadtxt(f"{tmp_path}/t.tum.txt"), np.loadtxt(f"{tmp_path}/j.tum.txt")
    assert np.array_equal(st[:, 0], sj[:, 0]) and st.shape == (N, 8)


def test_kitti_pipelined_alignment(layout, tmp_path, capsys):
    """``--pipelined`` returns poses one frame late; the exported trajectory
    stays frame-aligned (the gates of ``tests/test_cli_e2e.py``: a shift by
    one frame at 0.55 m/frame would break the ATE bound)."""
    res = run(tcli, kitti_args(layout, tmp_path / "p", "--pipelined", "--device", "cpu"), capsys)
    assert res["frames"] == N and res["tracked"] >= N - 2, res
    assert res["ate_rmse"] < 0.05 * N * SPEED, res
    assert np.loadtxt(f"{tmp_path}/p.kitti.txt").shape == (N, 12)


def test_trace_writes_a_chrome_trace(layout, tmp_path, capsys):
    res = run(tcli, kitti_args(layout, tmp_path / "tr", "--frames", "3", "--trace",
                               str(tmp_path / "trace"), "--device", "cpu"), capsys)
    assert res["frames"] == 3
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


@pytest.mark.parametrize("flags", [["--distributed"], ["--ba-devices", "2"]])
def test_multi_gpu_flags_raise(layout, tmp_path, capsys, monkeypatch, flags):
    """The multi-device flags no longer raise.  ``--distributed`` without
    the ``SLAM_*`` variables is the single-process no-op (process 0);
    ``--ba-devices 2``, with the mesh's local device list two CPU slots,
    builds the SLAM over a two-slot mesh.  Both track the layout."""
    from orb_slam2_ros2_tpu_torch.parallel import mesh as tmesh
    from orb_slam2_ros2_tpu_torch.pipeline import system as tsys

    for var in ("SLAM_COORDINATOR", "SLAM_NUM_PROCESSES", "SLAM_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(tmesh, "local_devices", lambda devices=None: [torch.device("cpu")] * 2)
    meshes = []
    build = tsys.ba_mesh
    monkeypatch.setattr(tsys, "ba_mesh", lambda *a, **kw: meshes.append(build(*a, **kw)) or meshes[-1])
    tcli.main(kitti_args(layout, tmp_path / "x", "--device", "cpu", "--frames", "6", *flags))
    out = capsys.readouterr()
    res = json.loads(out.out.strip().splitlines()[-1])
    assert res["frames"] == 6 and res["tracked"] >= 5, res
    if flags == ["--distributed"]:
        assert "[distributed] process 0" in out.err and not meshes
        assert not torch.distributed.is_initialized()
    else:
        assert [m.size for m in meshes] == [2]


def test_runs_as_a_module():
    out = subprocess.run([sys.executable, "-m", "orb_slam2_ros2_tpu_torch.cli", "kitti", "--help"],
                         capture_output=True, text=True, cwd=REPO, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    for flag in ("--save-map", "--load-map", "--pipelined", "--viewer", "--trace", "--device"):
        assert flag in out.stdout
