"""The port's command line end to end on the CPU, against the gates of the
JAX package's ``tests/test_cli_e2e.py``, on KITTI odometry and TUM RGB-D
layouts written to disk from the port's renderer at 320×192 (the
configuration of that file):

* ``kitti`` with ``--viewer`` (at least two rendered PNGs of more than
  5000 bytes) and ``--save-map m.pb``, then a chain of runs that each load
  the map the last one saved — ``.pb`` → txt directory → npz stem — and
  track on (at most four frames lost, as ``test_cli_kitti_save_and_reuse_map``
  allows);
* ``tum``: every frame but two tracked, ATE under 5% of the path;
* ``train-vocab`` on the KITTI layout;
* ``viz``: the trajectory plot, the stereo-match figure and the HUD.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image
from test_cli_e2e import CFG_YAML
from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)

from orb_slam2_ros2_tpu_torch import cli, viz
from orb_slam2_ros2_tpu_torch.bow.vocabulary import load_vocabulary
from orb_slam2_ros2_tpu_torch.config import CameraConfig
from orb_slam2_ros2_tpu_torch.io.synthetic import SyntheticStereoDataset
from orb_slam2_ros2_tpu_torch.io.trajectory import rotation_to_quat, write_kitti

CAM = CameraConfig(fx=200.0, fy=200.0, cx=160.0, cy=96.0, baseline=0.5, width=320, height=192)
N_KITTI, KITTI_SPEED = 12, 0.55
N_TUM, TUM_SPEED = 14, 0.4


def u8(img):
    return np.clip(img.numpy(), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A KITTI layout (image_0/ image_1/ times.txt poses.txt), a TUM layout
    (rgb/ depth/ associate.txt groundtruth.txt, uint16 depth at 5000 per
    metre) and the two configurations."""
    root = tmp_path_factory.mktemp("layouts")
    seq = root / "00"
    for d in ("image_0", "image_1"):
        (seq / d).mkdir(parents=True)
    ds = SyntheticStereoDataset(CAM, n_frames=N_KITTI, speed=KITTI_SPEED, device="cpu")
    poses = []
    for i in range(N_KITTI):
        img_l, img_r, Twc = ds.frame(i)
        Image.fromarray(u8(img_l)).save(seq / "image_0" / f"{i:06d}.png")
        Image.fromarray(u8(img_r)).save(seq / "image_1" / f"{i:06d}.png")
        poses.append(Twc)
    (seq / "times.txt").write_text("".join(f"{0.1 * i:.6f}\n" for i in range(N_KITTI)))
    write_kitti(str(seq / "poses.txt"), poses)

    tum = root / "tum"
    (tum / "rgb").mkdir(parents=True)
    (tum / "depth").mkdir()
    ds = SyntheticStereoDataset(CAM, n_frames=N_TUM, speed=TUM_SPEED, device="cpu")
    assoc, gt = [], ["# ground truth"]
    for i in range(N_TUM):
        img, depth, Twc = ds.frame_with_depth(i)
        s = f"{1000.0 + 0.05 * i:.6f}"
        d = depth.numpy()
        d16 = np.where(np.isfinite(d) & (d > 0) & (d < 13.0), d * 5000.0, 0.0).astype(np.uint16)
        Image.fromarray(u8(img)).save(tum / "rgb" / f"{s}.png")
        Image.fromarray(d16).save(tum / "depth" / f"{s}.png")
        assoc.append(f"{s} rgb/{s}.png {s} depth/{s}.png")
        q, t = rotation_to_quat(Twc[:3, :3]), Twc[:3, 3]
        gt.append(f"{s} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} {q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}")
    (tum / "associate.txt").write_text("\n".join(assoc) + "\n")
    (tum / "groundtruth.txt").write_text("\n".join(gt) + "\n")
    (root / "kitti.yaml").write_text(CFG_YAML.format(cam_type=0))
    (root / "tum.yaml").write_text(CFG_YAML.format(cam_type=1))
    return root


def run(argv, capsys) -> dict:
    cli.main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def kitti(root, out, *extra):
    return ["kitti", "--seq", str(root / "00"), "--config", str(root / "kitti.yaml"),
            "--out", str(out), "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def first_run(root, tmp_path_factory):
    """``kitti`` with the viewer every 5 frames, saving the map as ``.pb``."""
    out = tmp_path_factory.mktemp("first")
    cli.main(kitti(root, out / "t", "--viewer", str(out / "film"), "--viewer-every", "5",
                   "--save-map", str(out / "m.pb")))
    return out


def test_kitti_with_viewer_and_pb_map(first_run, root):
    rows = np.loadtxt(first_run / "t.kitti.txt")
    assert rows.shape == (N_KITTI, 12)
    tum = np.loadtxt(first_run / "t.tum.txt")
    assert tum.shape == (N_KITTI, 8)
    assert np.abs(rows[:, 11] - KITTI_SPEED * np.arange(N_KITTI)).max() < 0.05 * N_KITTI * KITTI_SPEED
    frames = sorted((first_run / "film").glob("viewer_*.png"))
    assert len(frames) >= 2 and all(f.stat().st_size > 5000 for f in frames), frames
    assert (first_run / "m.pb").stat().st_size > 10_000


def test_map_formats_chain(first_run, root, tmp_path, capsys):
    """Each run loads the last run's map and saves it in the next format."""
    chain = [(str(first_run / "m.pb"), str(tmp_path) + "/txt/"),
             (str(tmp_path) + "/txt/", str(tmp_path / "stem")),
             (str(tmp_path / "stem"), "")]
    for load, save in chain:
        extra = ["--load-map", load] + (["--save-map", save] if save else [])
        res = run(kitti(root, tmp_path / "t", *extra), capsys)
        assert res["frames"] == N_KITTI and res["tracked"] >= N_KITTI - 4, (load, res)
        assert res["keyframes"] >= N_KITTI // 2 and res["ate_rmse"] < 0.05 * N_KITTI * KITTI_SPEED, res
    assert sorted(os.listdir(tmp_path / "txt")) == ["KeyFrames.txt", "MapPoints.txt"]
    assert os.path.exists(tmp_path / "stem.map.npz") and os.path.exists(tmp_path / "stem.vocab.npz")


def test_tum_layout(root, tmp_path, capsys):
    res = run(["tum", "--seq", str(root / "tum"), "--config", str(root / "tum.yaml"),
               "--out", str(tmp_path / "t"), "--device", "cpu"], capsys)
    assert res["frames"] == N_TUM and res["tracked"] >= N_TUM - 2, res
    assert res["ate_rmse"] < 0.05 * N_TUM * TUM_SPEED, res
    assert np.loadtxt(tmp_path / "t.kitti.txt").shape == (N_TUM, 12)


def test_train_vocab(root, tmp_path, capsys):
    out = str(tmp_path / "v.npz")
    res = run(["train-vocab", "--seq", str(root / "00"), "--frames", "2", "--branching", "3",
               "--depth", "2", "--out", out, "--device", "cpu"], capsys)
    assert res["words"] == 9 and res["descriptors"] > 500 and res["out"] == out
    v = load_vocabulary(out, "cpu")
    assert (v.branching, v.depth, v.n_words) == (3, 2, 9)


def test_viz(first_run, tmp_path):
    est = np.tile(np.eye(4), (5, 1, 1))
    est[:, 2, 3] = np.arange(5)
    assert viz.plot_trajectory(str(tmp_path / "traj.png"), est, est, np.random.default_rng(0).normal(size=(50, 3)))
    assert (tmp_path / "traj.png").stat().st_size > 5000
    rng = np.random.default_rng(1)
    uv = torch.from_numpy(rng.uniform(10, 150, (40, 2)).astype(np.float32))

    class Frame:
        feats = type("F", (), {"uv_raw": uv, "valid": torch.ones(40, dtype=torch.bool)})
        right_u = uv[:, 0] - 5.0

    img = torch.from_numpy(rng.uniform(0, 255, (192, 320)).astype(np.float32))
    assert viz.draw_stereo_matches(str(tmp_path / "stereo.png"), img, img, Frame)
    assert (tmp_path / "stereo.png").stat().st_size > 5000

    class Slam:
        n_keyframes, n_mappoints, loops_closed = 3, 40, 0
        state = type("S", (), {"name": "OK"})

    assert viz.hud_stats(Slam) == {"keyframes": 3, "mappoints": 40, "state": "OK", "loops_closed": 0}
