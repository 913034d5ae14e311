"""The one general generator: a traffic file's world and route, a
configuration's camera and a seed → the frames of a run, rendered on the
device in batches during set-up and quantised to what the datasets deliver
(KITTI: 8-bit grey stereo pairs; TUM: an 8-bit image and 16-bit depth in
sensor units, through the lens), then held on the host.  ``frame(i)`` hands
frame i over in the form ``cli kitti`` / ``cli tum`` hands a decoded frame
to ``SLAM.track()``: f32 arrays on the host (grey, and the right image or the
raw depth).

The stream holds ``warm_max_frames`` + ⌈``ceiling_frames_per_s`` ×
seconds⌉ frames; a run that uses them up before its window closes fails."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import lens, routes, world


class Stream(NamedTuple):
    a: np.ndarray           # uint8 [N, H, W]: the left image (stereo) or the image (RGB-D)
    b: np.ndarray           # uint8 [N, H, W] right image, or uint16 [N, H, W] raw depth
    gt_twc: np.ndarray      # f32 [N, 4, 4] ground truth
    seed_draws: dict        # what the seed chose (route phase, texture shift)

    def __len__(self) -> int:
        return self.a.shape[0]

    def frame(self, i: int):
        """Frame ``i`` as the CLI hands it to ``track()``."""
        return self.a[i].astype(np.float32), self.b[i].astype(np.float32)


def seed_rng(seed: int, salt: int) -> np.random.Generator:
    """A generator for one use of the run's seed (any whole number)."""
    return np.random.default_rng([int(seed) % (1 << 63), salt])


def n_frames(traffic: dict, seconds: float) -> int:
    return int(traffic["warm_max_frames"]) + int(math.ceil(traffic["ceiling_frames_per_s"] * seconds))


def route_poses(traffic: dict, n: int, seed: int):
    """(Twc [n, 4, 4] in the cell's metres, the seed's draws)."""
    r = dict(traffic["route"])
    kind = r.pop("kind")
    draws = {}
    rng = seed_rng(seed, 1)
    if r.pop("random_phase", False):
        draws["phase"] = r["phase"] = float(rng.uniform(0.0, 2.0 * np.pi))
    return routes.ROUTES[kind](n, **r), draws


def check_inside(traffic: dict, gt_twc: np.ndarray) -> None:
    """Every camera stands inside the box with ``margin_m`` to spare."""
    w = traffic["world"]
    s, scale = float(w["box_scale"]), float(w.get("world_scale", 1.0))
    p = gt_twc[:, :3, 3] / scale
    lo = np.array([-8.0 * s, -3.0 * s, w["z_range"][0]]) + w["margin_m"]
    hi = np.array([8.0 * s, 1.5 * s, w["z_range"][1]]) - w["margin_m"]
    bad = np.nonzero(((p < lo) | (p > hi)).any(axis=1))[0]
    if len(bad):
        raise ValueError(f"the route leaves the world's box at frame {bad[0]}: {p[bad[0]].tolist()}")


def build(traffic: dict, camera: dict, rgbd: bool, seed: int, seconds: float, device) -> Stream:
    """Render the run's stream on ``device`` (see the module's docstring)."""
    n = n_frames(traffic, seconds)
    gt, draws = route_poses(traffic, n, seed)
    check_inside(traffic, gt)
    w = traffic["world"]
    scale = float(w.get("world_scale", 1.0))
    rng = seed_rng(seed, 2)
    shift = float(rng.uniform(*w["tex_shift_z_m"])) if "tex_shift_z_m" in w else 0.0
    draws["tex_shift_z_m"] = shift
    kw = dict(box_scale=float(w["box_scale"]), z_range=tuple(w["z_range"]), sky=bool(w.get("sky", False)),
              tex_offset=(0.0, 0.0, shift))
    H, W = int(camera["height"]), int(camera["width"])
    K = np.array([[camera["fx"], 0, camera["cx"]], [0, camera["fy"], camera["cy"]], [0, 0, 1]], np.float32)
    K_inv = torch.from_numpy(np.linalg.inv(K)).to(device)
    distorted = any(float(camera.get(k, 0.0)) != 0.0 for k in ("k1", "k2", "p1", "p2", "k3"))
    cam_t = lens.camera_tensors(camera, device)
    a = np.empty((n, H, W), np.uint8)
    b = np.empty((n, H, W), np.uint16 if rgbd else np.uint8)
    render_twc = gt.copy()
    render_twc[:, :3, 3] /= scale
    batch = int(traffic.get("render_batch", 16))
    for i0 in range(0, n, batch):
        T = torch.from_numpy(render_twc[i0:i0 + batch]).to(device)
        m = T.shape[0]
        if rgbd:
            img, depth = world.render(K_inv, T, H, W, **kw)
            depth = depth * (scale * float(camera["depth_scale"]))
            if distorted:
                img, depth = lens.warp_to_distorted(cam_t, img, depth)
            dq = torch.where(torch.isfinite(depth), depth, 0.0).round().clamp(0, 65535)
            b[i0:i0 + m] = dq.to(torch.int32).cpu().numpy().astype(np.uint16)
        else:
            right = torch.eye(4, device=device)
            right[0, 3] = float(camera["baseline"]) / scale
            img, _ = world.render(K_inv, torch.cat([T, T @ right]), H, W, **kw)
            b[i0:i0 + m] = img[m:].round().clamp(0, 255).to(torch.uint8).cpu().numpy()
            img = img[:m]
        a[i0:i0 + m] = img.round().clamp(0, 255).to(torch.uint8).cpu().numpy()
    return Stream(a, b, gt.astype(np.float32), draws)
