"""Dataset readers: KITTI odometry (stereo) and TUM RGB-D (port of
``orb_slam2_ros2_tpu/io/datasets.py``).

Mirrors the reference example drivers (example/Stereo/KittiStereo.cc:28-37 —
times.txt + image_0/image_1 pngs; example/RGB-D/TUMRGBD.cc:28-34 — an
association file of rgb/depth pairs).  Images are decoded on the host into
f32 grayscale numpy arrays, bit for bit the JAX package's: the native decoder
(``native_loader``) first, Pillow where it is unavailable; ``decoders``
counts which one served each image.  ``SLAM.track`` copies them to the device.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import native_loader

# images decoded in this process, by decoder
decoders = {"native": 0, "pillow": 0}


def _pillow(path: str, gray: bool) -> np.ndarray:
    from PIL import Image

    decoders["pillow"] += 1
    img = Image.open(path)
    if gray and img.mode != "L":
        img = img.convert("L")
    return np.asarray(img, dtype=np.float32)


def _load_gray(path: str) -> np.ndarray:
    out = native_loader.decode_png(path)
    if out is not None:
        decoders["native"] += 1
        return out
    return _pillow(path, gray=True)


class KittiStereoDataset:
    """KITTI odometry sequence: image_0/ (left), image_1/ (right), times.txt."""

    def __init__(self, seq_dir: str):
        self.dir = seq_dir
        with open(os.path.join(seq_dir, "times.txt")) as f:
            self.times: List[float] = [float(x) for x in f.read().split()]
        self.left_dir = os.path.join(seq_dir, "image_0")
        self.right_dir = os.path.join(seq_dir, "image_1")
        self.n_frames = len(self.times)

    @staticmethod
    def available(seq_dir: str) -> bool:
        return os.path.isdir(os.path.join(seq_dir, "image_0")) and os.path.exists(
            os.path.join(seq_dir, "times.txt"))

    def __len__(self) -> int:
        return self.n_frames

    def frame(self, i: int) -> Tuple[np.ndarray, np.ndarray, float]:
        name = f"{i:06d}.png"
        left = _load_gray(os.path.join(self.left_dir, name))
        right = _load_gray(os.path.join(self.right_dir, name))
        return left, right, self.times[i]


def load_kitti_gt(seq_dir: str, explicit: str = "") -> Optional[np.ndarray]:
    """KITTI odometry ground-truth poses of a sequence: [N, 4, 4] Twc, one
    row-major 3×4 [R|t] per line.  Searched in order: ``explicit``,
    ``{seq_dir}/poses.txt``, ``{seq_dir}/{seq}.txt`` and the official
    ``{seq_dir}/../../poses/{seq}.txt``.  A malformed file warns and gives
    None: ground truth is optional evaluation input, read after tracking."""
    seq = os.path.basename(os.path.normpath(seq_dir))
    candidates = [
        explicit,
        os.path.join(seq_dir, "poses.txt"),
        os.path.join(seq_dir, f"{seq}.txt"),
        os.path.join(seq_dir, "..", "..", "poses", f"{seq}.txt"),
    ]
    for path in candidates:
        if path and os.path.exists(path):
            try:
                rows = np.loadtxt(path, dtype=np.float64).reshape(-1, 3, 4)
            except ValueError as e:
                print(f"warning: bad gt file {path}: {e}", file=sys.stderr)
                return None
            T = np.tile(np.eye(4), (len(rows), 1, 1))
            T[:, :3, :4] = rows
            return T
    return None


def load_tum_gt(seq_dir: str, explicit: str = "") -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """TUM ground truth: (stamps [N], Twc [N, 4, 4]) from groundtruth.txt
    (``t tx ty tz qx qy qz qw`` lines)."""
    path = explicit or os.path.join(seq_dir, "groundtruth.txt")
    if not os.path.exists(path):
        return None
    stamps, poses = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 8:
                continue
            t = float(parts[0])
            tx, ty, tz, qx, qy, qz, qw = (float(x) for x in parts[1:8])
            n = max(qx * qx + qy * qy + qz * qz + qw * qw, 1e-12) ** 0.5
            qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
            T = np.eye(4)
            T[:3, :3] = [
                [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
                [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
                [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
            ]
            T[:3, 3] = (tx, ty, tz)
            stamps.append(t)
            poses.append(T)
    if not stamps:
        return None
    return np.asarray(stamps), np.stack(poses)


def associate_gt(stamps: Sequence[float], gt_stamps: np.ndarray, gt_poses: np.ndarray,
                 max_dt: float = 0.02) -> List[Optional[np.ndarray]]:
    """Nearest-stamp association of frame stamps to ground truth (the
    evo/TUM ``associate.py`` convention: the closest within ``max_dt``)."""
    out: List[Optional[np.ndarray]] = []
    for s in stamps:
        i = int(np.argmin(np.abs(gt_stamps - s)))
        out.append(gt_poses[i] if abs(float(gt_stamps[i]) - s) <= max_dt else None)
    return out


class TumRGBDDataset:
    """TUM RGB-D sequence via an association file: ``t_rgb rgb t_d depth``."""

    def __init__(self, seq_dir: str, association_file: Optional[str] = None):
        self.dir = seq_dir
        assoc = association_file or os.path.join(seq_dir, "associate.txt")
        self.entries: List[Tuple[float, str, str]] = []
        with open(assoc) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 4 and not line.startswith("#"):
                    self.entries.append((float(parts[0]), parts[1], parts[3]))
        self.n_frames = len(self.entries)

    @staticmethod
    def available(seq_dir: str) -> bool:
        return os.path.exists(os.path.join(seq_dir, "associate.txt"))

    def __len__(self) -> int:
        return self.n_frames

    def frame(self, i: int) -> Tuple[np.ndarray, np.ndarray, float]:
        """Returns (gray f32 [H, W], depth_raw f32 [H, W], stamp).  Depth
        stays in raw sensor units (Pillow keeps all 16 bits); the frontend
        divides by Camera.DepthScale (reference Frame.cc:125-159)."""
        t, rgb_rel, depth_rel = self.entries[i]
        gray = _load_gray(os.path.join(self.dir, rgb_rel))
        return gray, _pillow(os.path.join(self.dir, depth_rel), gray=False), t
