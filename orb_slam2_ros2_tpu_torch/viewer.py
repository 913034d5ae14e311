"""Live viewer (port of ``orb_slam2_ros2_tpu/viewer.py``) — the reference's
Pangolin/OpenCV viewer thread re-homed.

The reference runs a GL loop drawing the current pose frustum, keyframe
frustums, the covisibility/spanning-tree/loop graph, the map points and an
OpenCV HUD with KF/MP/loop counters (src/Viewer.cc:27-156,
System.cc:115-120).  This viewer keeps the same content with matplotlib
(imported on construction; without matplotlib the viewer does nothing):

- interactive mode (a display available): a window redrawn every ``every``
  frames;
- headless mode: the same frame rendered to ``out_dir/viewer_%06d.png``.

Attach with ``viewer = LiveViewer(slam)`` and call ``viewer.update(pose)``
once per tracked frame (the CLI wires this behind ``--viewer``).  A redraw
reads six map fields back from the device, one ``.cpu()`` each, outside the
SLAM's sync debug modes.  In pipelined mode that read waits for the frame in
flight: the viewer is opt-in, so this costs only the runs that ask for it.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


class LiveViewer:
    """Periodic renderer of trajectory + map + graph + HUD counters."""

    def __init__(self, slam, every: int = 10, out_dir: Optional[str] = None,
                 interactive: Optional[bool] = None, max_points: int = 20000):
        self.slam = slam
        self.every = max(int(every), 1)
        self.out_dir = out_dir
        self.max_points = max_points
        self._n = 0
        self._ok = True
        try:
            import matplotlib
        except ImportError:
            self._ok = False
            return
        if interactive is None:
            interactive = bool(os.environ.get("DISPLAY"))
        if not interactive:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        self._plt = plt
        self._interactive = interactive
        self._fig, self._ax = plt.subplots(figsize=(7, 7))
        if interactive:
            plt.ion()
            self._fig.show()
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)

    # ------------------------------------------------------------------
    def update(self, pose_cw: Optional[np.ndarray]) -> None:
        """Call once per tracked frame; redraws every ``every`` calls."""
        self._n += 1
        if not self._ok or self._n % self.every:
            return
        self._redraw()

    def _frustum(self, Twc: np.ndarray, scale: float = 0.6) -> np.ndarray:
        """Camera frustum outline points in world x-z (top-down view)."""
        c = Twc[:3, 3]
        fwd = Twc[:3, 2] * scale
        side = Twc[:3, 0] * (scale * 0.5)
        return np.stack([c + fwd - side, c, c + fwd + side])

    def _redraw(self) -> None:
        slam = self.slam
        ax = self._ax
        ax.clear()
        # one read of each drawn field per redraw (the reference viewer
        # pulls under the map mutex, Viewer.cc:44-56)
        m = slam.map
        kf_Tcw, kf_valid, kf_parent, mp_pos, mp_valid, loop_edges = (
            t.cpu().numpy() for t in (m.kf_Tcw, m.kf_valid, m.kf_parent, m.mp_pos, m.mp_valid,
                                      m.loop_edges))

        pts = mp_pos[mp_valid]
        if len(pts) > self.max_points:
            pts = pts[:: len(pts) // self.max_points + 1]
        if len(pts):
            ax.scatter(pts[:, 0], pts[:, 2], s=0.3, c="#c9c9c9", zorder=1,
                       label=f"map points ({int(mp_valid.sum())})")

        # keyframe frustums + spanning tree (Viewer.cc drawGraph)
        kf_ids = np.nonzero(kf_valid)[0]
        Twc_all = {int(k): np.linalg.inv(kf_Tcw[k]) for k in kf_ids}
        for k in kf_ids:
            f = self._frustum(Twc_all[int(k)])
            ax.plot(f[:, 0], f[:, 2], "-", c="#2a6fbb", lw=0.6, zorder=2)
            p = int(kf_parent[k])
            if p >= 0 and kf_valid[p]:
                a, b = Twc_all[int(k)][:3, 3], Twc_all[p][:3, 3]
                ax.plot([a[0], b[0]], [a[2], b[2]], "-", c="#8db8e8",
                        lw=0.5, zorder=2)
        for i, j in loop_edges:
            if i >= 0 and j >= 0 and kf_valid[i] and kf_valid[j]:
                a, b = Twc_all[int(i)][:3, 3], Twc_all[int(j)][:3, 3]
                ax.plot([a[0], b[0]], [a[2], b[2]], "-", c="#d62728",
                        lw=1.4, zorder=3, label="loop edge")

        # trajectory + current pose (Viewer.cc drawPose)
        if slam.trajectory:
            tr = np.stack([np.linalg.inv(T)[:3, 3] for _, T in slam.trajectory])
            ax.plot(tr[:, 0], tr[:, 2], "-", c="#1f77b4", lw=1.2, zorder=4)
            cur = np.linalg.inv(slam.trajectory[-1][1])
            f = self._frustum(cur, scale=1.0)
            ax.plot(f[:, 0], f[:, 2], "-", c="#2ca02c", lw=2.0, zorder=5)

        from .viz import hud_stats

        hud = hud_stats(slam)
        ax.set_title(
            f"frame {self._n}  KFs {hud['keyframes']}  MPs {hud['mappoints']}  "
            f"loops {hud['loops_closed']}  [{hud['state']}]"
        )
        ax.set_xlabel("x [m]")
        ax.set_ylabel("z [m]")
        ax.set_aspect("equal")
        if self._interactive:
            self._fig.canvas.draw_idle()
            self._fig.canvas.flush_events()
        if self.out_dir:
            self._fig.savefig(
                os.path.join(self.out_dir, f"viewer_{self._n:06d}.png"), dpi=90)

    def close(self) -> None:
        if self._ok:
            self._plt.close(self._fig)
