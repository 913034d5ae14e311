"""What decides ``correct``: the frontend's output for a sample of the
window's keyframes against the plain reference worked out again from the
same frames (``frontend.py``), the delivered trajectory against the
generator's ground truth, and the frames lost.  Each number is printed
beside its limit; the configuration file holds the limits.  Imports nothing
of the port."""

from __future__ import annotations

import numpy as np
import torch

from .. import roofline
from . import frontend, mapping, trajectory

UV_TOL_PX = 1e-3   # a keypoint "at the same place" (both sides give whole or identically rounded pixels)


def reference_features(a: np.ndarray, b: np.ndarray, slam_section: dict, rgbd: bool, device,
                       precision: str) -> dict:
    """The reference's features of one frame (CPU tensors) and the work
    the two kernels' jobs need on it."""
    with torch.no_grad():
        out = frontend.frontend(torch.from_numpy(a).to(device), torch.from_numpy(b).to(device), slam_section,
                                rgbd, precision)
    work = {"k1": roofline.k1_work(out["level_shapes"], out["batch"]),
            "k2": roofline.k2_work(out["canvas_shape"], out["centers"].cpu().numpy())}
    feats = {k: out[k].cpu() for k in ("uv", "octave", "desc", "valid", "right_u", "depth")}
    return dict(feats, work=work)


def compare_features(port: list, ref: list) -> dict:
    """Shares (%) of keypoint slots placed differently, of descriptor bits
    that differ on slots placed alike, and of those slots whose stereo or
    depth reading differs."""
    n_any = n_kp = n_same = n_bits = n_st = 0
    for p, r in zip(port, ref):
        either = p["valid"] | r["valid"]
        both = p["valid"] & r["valid"]
        placed = both & (p["octave"] == r["octave"]) & ((p["uv"] - r["uv"]).abs().amax(-1) <= UV_TOL_PX)
        n_any += int(either.sum())
        n_kp += int((either & ~placed).sum())
        n_same += int(placed.sum())
        bits = frontend.unpack_bits(p["desc"][placed]) != frontend.unpack_bits(r["desc"][placed])
        n_bits += int(bits.sum())
        pd, rd = p["depth"][placed], r["depth"][placed]
        pu, ru = p["right_u"][placed], r["right_u"][placed]
        has = (pd > 0) & (rd > 0)
        differ = ((pd > 0) != (rd > 0)) | (has & (((pu - ru).abs() > UV_TOL_PX)
                                                  | ((pd - rd).abs() > 1e-4 * rd.abs())))
        n_st += int(differ.sum())
    return {
        "kp_mismatch_pct": 100.0 * n_kp / max(n_any, 1),
        "desc_bits_pct": 100.0 * n_bits / max(256 * n_same, 1),
        "stereo_mismatch_pct": 100.0 * n_st / max(n_same, 1),
        "slots_compared": n_any,
    }


def judge(config: dict, slam_section: dict, gt_twc: np.ndarray, live: list, final: list, port: list, ref: list,
          map_samples: list, map_points: dict, lost: list) -> dict:
    """``correct`` and each number beside its limit."""
    # the frontend's numbers the configuration compares (an RGB-D frame's
    # depth is read from the depth map at the keypoint: no precision moves
    # it, so that configuration does not compare stereo_mismatch_pct), and
    # what a reference solve still removes from the robust reprojection cost
    # of the sampled keyframes' points and poses (mapping)
    limits = dict(config["check"]["limits"])
    cmp = compare_features(port, ref) if port else {"slots_compared": 0}
    ba = slam_section["ba"]
    poses = mapping.judge(map_samples, ref, map_points, slam_section["camera"],
                          float(slam_section["orb"]["scale_factor"]), float(ba["chi2_mono"]),
                          float(ba["chi2_stereo"])) if map_samples else {}
    cmp.update(poses)
    values = {k: cmp.get(k, float("inf")) for k in limits}
    g = config["guarantees"]
    live_pct, live_m, path_m = trajectory.ate_pct_of_path(live, gt_twc)
    final_pct, final_m, _ = trajectory.ate_pct_of_path(final, gt_twc)
    values.update(ate_live_pct=live_pct, ate_final_pct=final_pct, lost_frames=float(len(lost)))
    limits.update(ate_live_pct=g["ate_live_pct_of_path"], ate_final_pct=g["ate_final_pct_of_path"],
                  lost_frames=g["lost_frames"])
    # a number that could not be read (no keyframe, no path) fails, as 1e30
    checks = {k: {"value": float(values[k]) if np.isfinite(values[k]) else 1e30, "limit": float(limits[k])}
              for k in values}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    detail = dict(slots_compared=cmp["slots_compared"], stereo_mismatch_pct=cmp.get("stereo_mismatch_pct"),
                  **{k: v for k, v in poses.items() if k not in limits},
                  ate_live_m=live_m, ate_final_m=final_m, path_m=path_m, poses_live=len(live),
                  poses_final=len(final))
    return {"correct": bool(ok), "checks": checks, "detail": detail}
