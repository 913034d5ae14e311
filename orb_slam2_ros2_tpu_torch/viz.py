"""Offline visualization: trajectory and map dumps (port of
``orb_slam2_ros2_tpu/viz.py``).

The reference renders live with a Pangolin GL thread and an OpenCV HUD
(src/Viewer.cc:27-156); this module renders the trajectory and map-point
cloud to PNG with matplotlib (imported on use, Agg backend) for offline
inspection, and exports the counters the reference HUD shows.  Arrays may be
numpy arrays or tensors on any device (``draw_stereo_matches`` reads its
frame's fields once each).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _pyplot():
    """matplotlib's pyplot on the Agg backend; None where matplotlib is
    missing."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _np(a) -> np.ndarray:
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def plot_trajectory(
    path: str,
    est_wc: Sequence[np.ndarray],
    gt_wc: Optional[Sequence[np.ndarray]] = None,
    map_points: Optional[np.ndarray] = None,
    title: str = "trajectory",
) -> bool:
    """Top-down (x-z) plot; returns False when matplotlib is unavailable."""
    plt = _pyplot()
    if plt is None:
        return False

    fig, ax = plt.subplots(figsize=(8, 8))
    if map_points is not None and len(map_points):
        ax.scatter(map_points[:, 0], map_points[:, 2], s=0.3, c="#bbbbbb", label="map points")
    e = np.stack([np.asarray(T)[:3, 3] for T in est_wc])
    ax.plot(e[:, 0], e[:, 2], "-", c="#1f77b4", lw=1.5, label="estimate")
    if gt_wc is not None:
        g = np.stack([np.asarray(T)[:3, 3] for T in gt_wc])
        ax.plot(g[:, 0], g[:, 2], "--", c="#2ca02c", lw=1.0, label="ground truth")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend()
    ax.set_title(title)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return True


def hud_stats(slam) -> dict:
    """The reference HUD counters (Viewer.cc:140-153) as a dict."""
    return {
        "keyframes": slam.n_keyframes,
        "mappoints": slam.n_mappoints,
        "state": slam.state.name,
        "loops_closed": getattr(slam, "loops_closed", 0),
    }


def draw_stereo_matches(
    path: str,
    img_left: np.ndarray,
    img_right: np.ndarray,
    frame,
    max_lines: int = 200,
) -> bool:
    """Side-by-side stereo pair with keypoints and left→right match lines —
    the reference's manual-debug helper Frame::showStereoMatches
    (Frame.cc:16-50).  ``frame`` is a StereoFrame (uv_raw, right_u, depth).
    Returns False when matplotlib is unavailable."""
    plt = _pyplot()
    if plt is None:
        return False

    L = _np(img_left)
    R = _np(img_right)
    h, w = L.shape
    canvas = np.concatenate([L, R], axis=1)

    uv = _np(frame.feats.uv_raw)
    valid = _np(frame.feats.valid)
    right_u = _np(frame.right_u)
    matched = valid & (right_u > 0)

    fig, ax = plt.subplots(figsize=(14, 5))
    ax.imshow(canvas, cmap="gray", vmin=0, vmax=255)
    ax.scatter(uv[valid, 0], uv[valid, 1], s=4, c="#1f77b4", label="keypoints")
    idx = np.nonzero(matched)[0][:max_lines]
    for i in idx:
        ax.plot([uv[i, 0], right_u[i] + w], [uv[i, 1], uv[i, 1]],
                "-", c="#2ca02c", lw=0.4)
    ax.scatter(right_u[idx] + w, uv[idx, 1], s=4, c="#2ca02c",
               label=f"stereo matches ({int(matched.sum())})")
    ax.set_axis_off()
    ax.legend(loc="upper right")
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return True
