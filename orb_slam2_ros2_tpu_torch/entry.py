"""The port's entry point: the per-frame tracking program and example inputs.

The counterpart of the JAX package's ``__graft_entry__.entry()``, at its
shapes: 320×192 stereo, ``n_features=500``, ``max_keypoints=512``, 64
keyframe and 16,384 map-point slots, a ``SLAM`` initialized on frame 0 of the
synthetic sequence and frame 1's images as the input.

    fn, args = entry()            # on the card
    new_state, velocity, host_vec, mapstate, local = fn(*args)

On CUDA ``fn`` replays the captured frame graph (its first call captures it);
with ``device="cpu"`` it is the eager frame program.
"""

from __future__ import annotations

from .config import CameraConfig, MapConfig, ORBConfig, SLAMConfig, TrackingConfig
from .io.synthetic import SyntheticStereoDataset
from .pipeline.system import SLAM


def entry_config() -> SLAMConfig:
    """The configuration of ``__graft_entry__.entry()``."""
    return SLAMConfig(
        camera=CameraConfig(fx=200.0, fy=200.0, cx=160.0, cy=96.0, baseline=0.5,
                            width=320, height=192),
        orb=ORBConfig(n_features=500, max_keypoints=512),
        tracking=TrackingConfig(min_init_depth_kps=150, max_local_mappoints=4096,
                                max_local_keyframes=16),
        map=MapConfig(max_keyframes=64, max_mappoints=16384, max_obs_per_mp=16),
    )


def entry(device="cuda"):
    """Returns ``(fn, args)``: ``fn(img_l, img_r, last, velocity, local,
    mapstate, ref_kf)`` is the frame program of a ``SLAM`` initialized on
    synthetic frame 0 (frontend → motion match + pose LM → local-map search +
    refinement → counter bumps → stats), ``args`` frame 1's images, that
    SLAM's tracker state, its map and reference keyframe (a host int).
    Returns ``(new_state, velocity, host_vec, mapstate, local)``: the map is
    the SLAM's own (another ``mapstate`` is copied into it first), its
    tracking counters bumped in place, as ``SLAM.track`` does."""
    cfg = entry_config()
    ds = SyntheticStereoDataset(cfg.camera, n_frames=4, speed=0.35, device=device)
    slam = SLAM(cfg, enable_loop_closing=False, device=device)
    slam.track(*ds.frame(0)[:2])  # stereo init → keyframe 0 + local map
    img_l, img_r, _ = ds.frame(1)
    args = (img_l, img_r, slam.last, slam.velocity, slam.local, slam.map, slam.ref_kf)

    def fn(img_l, img_r, last, velocity, local, mapstate, ref_kf):
        # the SLAM's own frame step (graph or eager) on that map and keyframe
        slam.map, slam.ref_kf = mapstate, ref_kf
        new_state, velocity, host_vec, local = slam._run_frame(
            img_l, img_r, last, velocity, local, wide=False)
        return new_state, velocity, host_vec, slam.map, local

    return fn, args
