"""Trajectory output and evaluation (port of
``orb_slam2_ros2_tpu/io/trajectory.py``): KITTI- and TUM-format writers (the
reference example drivers' conventions, example/Stereo/KittiStereo.cc,
example/RGB-D/TUMRGBD.cc) and an evo-style ATE RMSE after a closed-form
SE(3)/Sim(3) Umeyama alignment.  Host-side numpy; the files are the JAX
package's, byte for byte."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def write_kitti(path: str, poses_wc: Sequence[np.ndarray]) -> None:
    """KITTI format: 12 numbers per line, row-major [R|t] of Twc."""
    with open(path, "w") as f:
        for T in poses_wc:
            f.write(" ".join(f"{v:.9e}" for v in np.asarray(T)[:3, :4].reshape(-1)) + "\n")


def write_tum(path: str, stamps: Sequence[float], poses_wc: Sequence[np.ndarray]) -> None:
    """TUM format: stamp tx ty tz qx qy qz qw."""
    with open(path, "w") as f:
        for s, T in zip(stamps, poses_wc):
            T = np.asarray(T)
            q = rotation_to_quat(T[:3, :3])
            t = T[:3, 3]
            f.write(f"{s:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} {q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")


def rotation_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix → quaternion (x, y, z, w); the largest-diagonal branch
    when the trace is not positive (near 180°)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s, 0.25 * s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4)
    q[i] = 0.25 * s
    q[j] = (R[j, i] + R[i, j]) / s
    q[k] = (R[k, i] + R[i, k]) / s
    q[3] = (R[k, j] - R[j, k]) / s
    return q


def umeyama_align(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Closed-form alignment dst ≈ s·R·src + t over [N, 3] point sets.
    Returns (s, R, t)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / max((xs ** 2).sum() / len(src), 1e-12)) if with_scale else 1.0
    return s, R, mu_d - s * R @ mu_s


def ate_rmse(est_wc: Sequence[np.ndarray], gt_wc: Sequence[np.ndarray], with_scale: bool = False) -> float:
    """Absolute trajectory error RMSE of camera-to-world poses after
    alignment."""
    est = np.stack([np.asarray(T)[:3, 3] for T in est_wc])
    gt = np.stack([np.asarray(T)[:3, 3] for T in gt_wc])
    s, R, t = umeyama_align(est, gt, with_scale)
    aligned = (s * (R @ est.T)).T + t
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=1))))
