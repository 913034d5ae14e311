"""The per-point bundle-adjustment problem layout (port of ``PointBAProblem``
and ``_chi2_point`` of ``orb_slam2_ros2_tpu/solvers/pcg_ba.py``).  The
global-BA PCG engine of that module belongs to the loop-closing slice and is
not ported yet."""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import edge_fm


class PointBAProblem(NamedTuple):
    """Per-point edge layout: P point slots × O observations each."""

    cam_Tcw: torch.Tensor      # f32[C, 4, 4]
    cam_free: torch.Tensor     # bool[C]
    pt_pos: torch.Tensor       # f32[P, 3]
    pt_valid: torch.Tensor     # bool[P]
    obs_cam: torch.Tensor      # i32[P, O] camera slot (−1 = none)
    obs_uv: torch.Tensor       # f32[P, O, 2]
    obs_right_u: torch.Tensor  # f32[P, O] (−1 = mono)
    obs_inv_sigma2: torch.Tensor  # f32[P, O]
    obs_valid: torch.Tensor    # bool[P, O]


def _chi2_point(cam, prob: PointBAProblem, Tcw: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Per-observation χ² [P, O], computed feature-major."""
    C = Tcw.shape[0]
    ci = prob.obs_cam.clamp(0, C - 1).T.long()                   # [O, P]
    Rf = Tcw[:, :3, :3].reshape(C, 9).T
    tf = Tcw[:, :3, 3].T
    chi2 = edge_fm.edge_chi2(
        cam, Rf[:, ci], tf[:, ci], pts.T[:, None, :],
        prob.obs_uv.permute(2, 1, 0), prob.obs_right_u.T, prob.obs_inv_sigma2.T,
    )
    return chi2.T
