"""The port's host-side readers and writers against the JAX package's, on the
same inputs made from a seed: trajectory files and quaternions (bytes and
bits), ground-truth readers and association, PNG decoding through the native
decoder and through Pillow (8-bit, 16-bit and RGB files), both dataset
readers, the prefetching loader, the ROS2 bridge's pairing policy and its
error without rclpy, and the byte-for-byte copies of the decoder source and
the map schema.  All exact."""

import os

import numpy as np
import pytest
from PIL import Image

from orb_slam2_ros2_tpu import ros2_bridge as jros
from orb_slam2_ros2_tpu.io import datasets as jds
from orb_slam2_ros2_tpu.io import native_loader as jnl
from orb_slam2_ros2_tpu.io import trajectory as jtraj
from orb_slam2_ros2_tpu_torch import ros2_bridge as tros
from orb_slam2_ros2_tpu_torch.io import datasets as tds
from orb_slam2_ros2_tpu_torch.io import native_loader as tnl
from orb_slam2_ros2_tpu_torch.io import trajectory as ttraj

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rand_rot(rng):
    q = rng.normal(size=4)
    x, y, z, w = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def near_half_turn(rng, axis):
    """A rotation by 180° − ε about ``axis`` (trace ≈ −1: the branch that
    does not divide by the trace)."""
    a = np.zeros(3)
    a[axis] = 1.0
    a += rng.normal(scale=0.05, size=3)
    a /= np.linalg.norm(a)
    th = np.pi - rng.uniform(0, 1e-3)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def poses(rng, n):
    out = []
    for i in range(n):
        T = np.eye(4)
        T[:3, :3] = near_half_turn(rng, i % 3) if i % 2 else rand_rot(rng)
        T[:3, 3] = rng.normal(scale=20.0, size=3)
        out.append(T if i % 3 else T.astype(np.float32))
    return out


@pytest.fixture(scope="module")
def rng_poses():
    return poses(np.random.default_rng(7), 24)


def test_rotation_to_quat_bit_equal(rng_poses):
    rng = np.random.default_rng(3)
    Rs = [T[:3, :3] for T in rng_poses] + [np.eye(3), np.diag([1.0, -1.0, -1.0]),
                                          np.diag([-1.0, 1.0, -1.0]), np.diag([-1.0, -1.0, 1.0])]
    Rs += [near_half_turn(rng, k % 3) for k in range(9)]
    for R in Rs:
        q_t, q_j = ttraj.rotation_to_quat(R), jtraj.rotation_to_quat(R)
        assert q_t.dtype == q_j.dtype and np.array_equal(q_t, q_j)
        assert np.isclose(np.linalg.norm(q_t), 1.0, atol=1e-4)
        assert np.array_equal(np.asarray(tros._quat_from_R(R)), np.asarray(jros._quat_from_R(R)))


def test_trajectory_files_byte_equal(rng_poses, tmp_path):
    stamps = list(np.random.default_rng(1).uniform(0, 1e4, len(rng_poses)))
    for mod, tag in ((ttraj, "t"), (jtraj, "j")):
        mod.write_kitti(str(tmp_path / f"{tag}.kitti.txt"), rng_poses)
        mod.write_tum(str(tmp_path / f"{tag}.tum.txt"), stamps, rng_poses)
    for ext in ("kitti", "tum"):
        a = (tmp_path / f"t.{ext}.txt").read_bytes()
        assert a == (tmp_path / f"j.{ext}.txt").read_bytes()
        assert len(a.splitlines()) == len(rng_poses)


def test_ground_truth_readers_equal(rng_poses, tmp_path):
    seq = tmp_path / "00"
    seq.mkdir()
    jtraj.write_kitti(str(seq / "poses.txt"), rng_poses)
    a, b = tds.load_kitti_gt(str(seq)), jds.load_kitti_gt(str(seq))
    assert a.dtype == b.dtype and np.array_equal(a, b) and a.shape == (len(rng_poses), 4, 4)
    # the official layout (dataset/poses/{seq}.txt) and an explicit file
    root = tmp_path / "ds" / "sequences" / "01"
    root.mkdir(parents=True)
    (tmp_path / "ds" / "poses").mkdir()
    jtraj.write_kitti(str(tmp_path / "ds" / "poses" / "01.txt"), rng_poses[:3])
    assert np.array_equal(tds.load_kitti_gt(str(root)), jds.load_kitti_gt(str(root)))
    explicit = str(tmp_path / "ds" / "poses" / "01.txt")
    assert np.array_equal(tds.load_kitti_gt("", explicit), jds.load_kitti_gt("", explicit))
    assert tds.load_kitti_gt(str(tmp_path / "nowhere")) is None
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "poses.txt").write_text("1 2 3\n4 5\n")
    assert tds.load_kitti_gt(str(bad)) is None and jds.load_kitti_gt(str(bad)) is None

    stamps = np.random.default_rng(2).uniform(0, 100, len(rng_poses))
    jtraj.write_tum(str(tmp_path / "groundtruth.txt"), stamps, rng_poses)
    with open(tmp_path / "groundtruth.txt", "a") as f:
        f.write("# a comment\n1.0 2.0\n")
    (ts, tp), (js, jp) = tds.load_tum_gt(str(tmp_path)), jds.load_tum_gt(str(tmp_path))
    assert np.array_equal(ts, js) and np.array_equal(tp, jp)
    assert tds.load_tum_gt(str(tmp_path / "nowhere")) is None
    query = list(stamps[::2] + 0.01) + list(stamps[1::2] + 0.5) + [1e6]
    for max_dt in (0.02, 0.6):
        a = tds.associate_gt(query, ts, tp, max_dt)
        b = jds.associate_gt(query, js, jp, max_dt)
        assert [x is None for x in a] == [x is None for x in b]
        assert all(np.array_equal(x, y) for x, y in zip(a, b) if x is not None)
    assert sum(x is None for x in tds.associate_gt(query, ts, tp, 0.02)) == len(stamps[1::2]) + 1


def _pngs(tmp_path):
    rng = np.random.default_rng(11)
    h, w = 37, 53
    files = {
        "gray8": Image.fromarray(rng.integers(0, 256, (h, w), dtype=np.uint8)),
        "gray16": Image.fromarray(rng.integers(0, 65536, (h, w), dtype=np.uint16)),
        "rgb": Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)),
    }
    paths = {}
    for name, img in files.items():
        paths[name] = str(tmp_path / f"{name}.png")
        img.save(paths[name])
    return paths


@pytest.mark.parametrize("decoder", ["native", "pillow"])
def test_load_gray_bit_equal(decoder, tmp_path, monkeypatch):
    if decoder == "pillow":
        monkeypatch.setattr(tnl, "decode_png", lambda path: None)
        monkeypatch.setattr(jnl, "decode_png", lambda path: None)
    else:
        assert tnl.get_lib() is not None, tnl.build_error
        assert tnl.library_path().parent == tnl.BUILD_DIR
    for name, path in _pngs(tmp_path).items():
        before = dict(tds.decoders)
        a, b = tds._load_gray(path), jds._load_gray(path)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (37, 53)
        assert np.array_equal(a, b), name
        assert tds.decoders[decoder] == before[decoder] + 1
        assert sum(tds.decoders.values()) == sum(before.values()) + 1


def test_dataset_readers_equal(tmp_path):
    rng = np.random.default_rng(5)
    seq = tmp_path / "00"
    for d in ("image_0", "image_1"):
        (seq / d).mkdir(parents=True)
    n = 3
    for i in range(n):
        for d in ("image_0", "image_1"):
            Image.fromarray(rng.integers(0, 256, (24, 40), dtype=np.uint8)).save(seq / d / f"{i:06d}.png")
    (seq / "times.txt").write_text("".join(f"{0.1 * i:.6f}\n" for i in range(n)))
    assert tds.KittiStereoDataset.available(str(seq)) and not tds.KittiStereoDataset.available(str(tmp_path))
    t, j = tds.KittiStereoDataset(str(seq)), jds.KittiStereoDataset(str(seq))
    assert len(t) == len(j) == n and t.times == j.times
    for i in range(n):
        for a, b in zip(t.frame(i), j.frame(i)):
            assert np.array_equal(a, b)

    tum = tmp_path / "tum"
    (tum / "rgb").mkdir(parents=True)
    (tum / "depth").mkdir()
    lines = ["# rgb depth"]
    for i in range(n):
        s = f"{1000 + 0.05 * i:.6f}"
        Image.fromarray(rng.integers(0, 256, (24, 40, 3), dtype=np.uint8)).save(tum / "rgb" / f"{s}.png")
        Image.fromarray(rng.integers(0, 30000, (24, 40), dtype=np.uint16)).save(tum / "depth" / f"{s}.png")
        lines.append(f"{s} rgb/{s}.png {s} depth/{s}.png")
    (tum / "associate.txt").write_text("\n".join(lines) + "\n")
    assert tds.TumRGBDDataset.available(str(tum))
    t, j = tds.TumRGBDDataset(str(tum)), jds.TumRGBDDataset(str(tum))
    assert t.entries == j.entries and len(t) == n
    for i in range(n):
        ta, tb, ts = t.frame(i)
        ja, jb, js = j.frame(i)
        assert np.array_equal(ta, ja) and np.array_equal(tb, jb) and ts == js
        assert tb.max() > 255  # depth keeps its 16 bits


def test_prefetching_loader_equal(tmp_path):
    rng = np.random.default_rng(9)
    paths = []
    for i in range(6):
        paths.append(str(tmp_path / f"{i}.png"))
        Image.fromarray(rng.integers(0, 256, (20, 30), dtype=np.uint8)).save(paths[-1])
    paths.append(str(tmp_path / "missing.png"))
    t = tnl.PrefetchingLoader(paths, n_threads=3, depth=2)
    j = jnl.PrefetchingLoader(paths, n_threads=3, depth=2)
    assert len(t) == len(j) == 7
    for i in range(6):
        a, b = t.next((20, 30)), j.next((20, 30))
        assert np.array_equal(a, b) and np.array_equal(a, tds._load_gray(paths[i]))
    assert t.next((20, 30)) is None and j.next((20, 30)) is None   # the missing file
    assert t.next((20, 30)) is None                                  # past the end
    t.close()
    j.close()
    # a frame of another size than asked reads as None
    t = tnl.PrefetchingLoader(paths[:1], n_threads=1, depth=1)
    assert t.next((10, 10)) is None
    t.close()


def test_ros2_pairing_equal_and_import_error():
    rng = np.random.default_rng(4)
    for _ in range(20):
        left = [(float(s), f"L{i}") for i, s in enumerate(np.sort(rng.uniform(0, 2, rng.integers(0, 12))))]
        right = [(float(s), f"R{i}") for i, s in enumerate(np.sort(rng.uniform(0, 2, rng.integers(0, 12))))]
        for max_dt in (0.02, 0.2):
            assert tros._pair_frames(left, right, max_dt) == jros._pair_frames(left, right, max_dt)
    pairs, lrest, rrest = tros._pair_frames([(0.0, "L0"), (1.0, "L1")], [(0.0, "R0")])
    assert pairs == [("L0", "R0")] and lrest == [(1.0, "L1")] and rrest == []
    with pytest.raises(ImportError, match="rclpy") as err:
        tros.main(["--left", "x", "--right", "y"])
    assert "orb_slam2_ros2_tpu_torch.cli" in str(err.value)
    with pytest.raises(ImportError, match="rclpy"):
        jros.main(["--left", "x", "--right", "y"])


@pytest.mark.parametrize("copy,original", [
    ("orb_slam2_ros2_tpu_torch/csrc/dataloader.cpp", "native/dataloader.cpp"),
    ("orb_slam2_ros2_tpu_torch/proto/orbslam2_map.proto", "orb_slam2_ros2_tpu/proto/orbslam2_map.proto"),
    ("orb_slam2_ros2_tpu_torch/proto/orbslam2_map_pb2.py", "orb_slam2_ros2_tpu/proto/orbslam2_map_pb2.py"),
])
def test_copied_sources_byte_equal(copy, original):
    """The package carries byte-for-byte copies of the decoder source and of
    the map schema (any other descriptor registered under the schema's file
    name would clash with the JAX package's in one process)."""
    with open(os.path.join(REPO, copy), "rb") as a, open(os.path.join(REPO, original), "rb") as b:
        assert a.read() == b.read()
