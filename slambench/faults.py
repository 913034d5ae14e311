"""Faults planted in the system under test, each a ``plant(slam)`` that
breaks the timed path underneath the harness and returns an ``undo`` (or
None).  The benchmark's runs plant none; the CPU tests and
``slambench.readings`` plant them to show that ``correct`` comes out false
and to read each compared number's upper reading.

- ``frontend_state_unchanged``: the frontend hands back its first frame.
- ``frontend_half_left_out``: half of each frame's keypoints left out.
- ``frontend_answer_altered``: every descriptor altered where it is made.
- ``ba_skipped``: the mapping tail runs no local BA (the keyframe poses and
  points stay as insertion, triangulation and the fuses left them).
- ``ba_poses_unchanged``: local BA moves the points, but the keyframe
  poses it wrote are put back as they were.
- ``track_pose_unchanged``: tracking's pose optimisations (and
  relocalization's) return the pose they were given, their inliers kept.
"""

from __future__ import annotations

import dataclasses


def _frontend(kind):
    def plant(slam):
        inner = slam._frontend
        first = []

        def faulty(img_l, img_r, cam):
            frame = inner(img_l, img_r, cam)
            f = frame.feats
            if kind == "state_unchanged":
                if not first:
                    first.append(frame)
                return first[0]
            if kind == "half_left_out":
                valid = f.valid.clone()
                valid[valid.shape[0] // 2:] = False
                return frame._replace(feats=f._replace(valid=valid))
            return frame._replace(feats=f._replace(desc=f.desc ^ 0x0F0F0F0F))

        slam._frontend = faulty
    return plant


def ba_skipped(slam):
    slam.cfg = slam.cfg.replace(mapping=dataclasses.replace(slam.cfg.mapping, ba_stride=0))


def ba_poses_unchanged(slam):
    graphs = slam._kf_graphs
    inner = graphs.map_tail

    def faulty(mapstate, kf_id, do_ba, do_cull):
        before = mapstate.kf_Tcw.clone()
        out = inner(mapstate, kf_id, do_ba, do_cull)
        mapstate.kf_Tcw.copy_(before)
        return out

    graphs.map_tail = faulty


def track_pose_unchanged(slam):
    from orb_slam2_ros2_tpu_torch.pipeline import system

    inner = system.optimize_pose

    def faulty(cam, Tcw0, obs, **kw):
        Tcw, inlier, n = inner(cam, Tcw0, obs, **kw)
        return Tcw0.expand_as(Tcw).clone(), inlier, n

    system.optimize_pose = faulty

    def undo():
        system.optimize_pose = inner
    return undo


FAULTS = {
    "frontend_state_unchanged": _frontend("state_unchanged"),
    "frontend_half_left_out": _frontend("half_left_out"),
    "frontend_answer_altered": _frontend("answer_altered"),
    "ba_skipped": ba_skipped,
    "ba_poses_unchanged": ba_poses_unchanged,
    "track_pose_unchanged": track_pose_unchanged,
}
