"""Trajectory arithmetic: a frozen copy of ``io/trajectory.py``'s
``umeyama_align`` and ``ate_rmse``, and the ATE gate of
``tools/bench_full.py`` as a share of the path."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def umeyama_align(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Closed-form alignment dst ≈ s·R·src + t over [N, 3] point sets."""
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


def ate_pct_of_path(pairs, gt_twc: np.ndarray) -> tuple:
    """(ATE as % of the path, ATE m, path m) of (frame id, Tcw) pairs
    against the ground truth Twc of each frame id."""
    pairs = [(f, T) for f, T in pairs if 0 <= f < len(gt_twc)]
    if len(pairs) < 3:
        return float("inf"), float("inf"), 0.0
    fids = [f for f, _ in pairs]
    ate = ate_rmse([np.linalg.inv(np.asarray(T, np.float64)) for _, T in pairs], [gt_twc[f] for f in fids])
    path = float(sum(np.linalg.norm(gt_twc[b][:3, 3] - gt_twc[a][:3, 3]) for a, b in zip(fids, fids[1:])))
    return (100.0 * ate / path if path > 0 else float("inf")), ate, path
