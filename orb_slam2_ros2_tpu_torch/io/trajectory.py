"""Trajectory evaluation (port of ``umeyama_align`` and ``ate_rmse`` of
``orb_slam2_ros2_tpu/io/trajectory.py``): evo-style ATE RMSE after a
closed-form SE(3)/Sim(3) Umeyama alignment.  Host-side numpy."""

from __future__ import annotations

from typing import Sequence

import numpy as np


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
