"""Optional ROS2 bridge (port of ``orb_slam2_ros2_tpu/ros2_bridge.py``) —
the reference's node surface as a thin adapter over ``SLAM.track()``.

The reference is itself a ROS2 node: it subscribes to a stereo-pair topic
and publishes the pose and a lost flag (System.cc:132-168,
ORB_SLAM2_interfaces/msg/Camera.msg, msg/LostFlag.msg).  This bridge:

- subscribes two ``sensor_msgs/Image`` topics (left/right, or RGB/depth with
  ``--rgbd``) with approximate-time pairing (``_pair_frames``);
- publishes ``geometry_msgs/PoseStamped`` on ``ORB_SLAM2/Pose`` and
  ``std_msgs/Bool`` on ``ORB_SLAM2/Lost`` — the reference's topic names.

rclpy is imported only inside ``main``; without it ``main`` raises an
``ImportError`` that names the CLI.  The decoded images reach the device
through ``track``'s pinned staging buffers.

Run:  python -m orb_slam2_ros2_tpu_torch.ros2_bridge --config cfg.yaml \
          --left /camera/left --right /camera/right
"""

from __future__ import annotations

from typing import List, Optional, Tuple


def _quat_from_R(R):
    """Unit quaternion (qx, qy, qz, qw) of a rotation matrix
    (``io.trajectory.rotation_to_quat``: its largest-diagonal branch holds
    at 180° rotations, e.g. a robot completing a U-turn)."""
    from .io.trajectory import rotation_to_quat

    return tuple(rotation_to_quat(R))


def _pair_frames(
    left: List[Tuple[float, object]],
    right: List[Tuple[float, object]],
    max_dt: float = 0.02,
) -> Tuple[List[Tuple[object, object]], List[Tuple[float, object]], List[Tuple[float, object]]]:
    """Approximate-time pairing of two stamped queues (the reference gets
    this from its composite Camera.msg; standard stereo drivers publish two
    topics).  Returns (pairs, left_rest, right_rest); consumed entries and
    anything older than a matched stamp are dropped — pure function so the
    policy is unit-testable without ROS."""
    pairs = []
    li = ri = 0
    while li < len(left) and ri < len(right):
        tl, l = left[li]
        tr, r = right[ri]
        if abs(tl - tr) <= max_dt:
            pairs.append((l, r))
            li += 1
            ri += 1
        elif tl < tr:
            li += 1
        else:
            ri += 1
    return pairs, left[li:], right[ri:]


def main(argv=None):
    try:
        import rclpy
        from rclpy.node import Node
        from geometry_msgs.msg import PoseStamped
        from sensor_msgs.msg import Image
        from std_msgs.msg import Bool
    except ImportError as e:  # pragma: no cover - env has no ROS2
        raise ImportError(
            "the ROS2 bridge needs rclpy + common_interfaces installed "
            "(source a ROS2 distribution); the core framework does not — "
            "use orb_slam2_ros2_tpu_torch.cli or the SLAM.track() API directly"
        ) from e

    import argparse

    import numpy as np

    from .config import SLAMConfig
    from .pipeline.system import SLAM

    ap = argparse.ArgumentParser(prog="orb_slam2_ros2_tpu_torch.ros2_bridge")
    ap.add_argument("--config", default="")
    ap.add_argument("--left", default="ORB_SLAM2/left")
    ap.add_argument("--right", default="ORB_SLAM2/right")
    ap.add_argument("--rgbd", action="store_true")
    ap.add_argument("--max-dt", type=float, default=0.02)
    ap.add_argument("--device", default="cuda", help="torch device to track on")
    args = ap.parse_args(argv)

    cfg = SLAMConfig.from_yaml(args.config) if args.config else SLAMConfig()

    class Bridge(Node):  # pragma: no cover - needs a ROS2 runtime
        def __init__(self):
            super().__init__("orb_slam2_tpu")
            self.slam = SLAM(cfg, rgbd=args.rgbd, device=args.device)
            self._left: list = []
            self._right: list = []
            self.create_subscription(Image, args.left, self._on_left, 10)
            self.create_subscription(Image, args.right, self._on_right, 10)
            self.pub_pose = self.create_publisher(PoseStamped, "ORB_SLAM2/Pose", 10)
            self.pub_lost = self.create_publisher(Bool, "ORB_SLAM2/Lost", 10)

        @staticmethod
        def _decode(msg):
            arr = np.frombuffer(bytes(msg.data), dtype=np.uint8)
            if msg.encoding in ("mono8", "8UC1"):
                return arr.reshape(msg.height, msg.width).astype(np.float32)
            if msg.encoding == "16UC1":
                return (
                    np.frombuffer(bytes(msg.data), dtype=np.uint16)
                    .reshape(msg.height, msg.width).astype(np.float32)
                )
            return arr.reshape(msg.height, msg.width, -1)[..., :3]

        def _stamp(self, msg):
            return msg.header.stamp.sec + 1e-9 * msg.header.stamp.nanosec

        def _on_left(self, msg):
            self._left.append((self._stamp(msg), msg))
            self._drain()

        def _on_right(self, msg):
            self._right.append((self._stamp(msg), msg))
            self._drain()

        def _drain(self):
            pairs, self._left, self._right = _pair_frames(
                self._left, self._right, args.max_dt)
            for lmsg, rmsg in pairs:
                Tcw, _ = self.slam.track(self._decode(lmsg), self._decode(rmsg))
                lost = Bool()
                lost.data = Tcw is None
                self.pub_lost.publish(lost)
                if Tcw is None:
                    continue
                Twc = np.linalg.inv(Tcw)
                p = PoseStamped()
                p.header = lmsg.header
                p.pose.position.x, p.pose.position.y, p.pose.position.z = (
                    float(v) for v in Twc[:3, 3])
                qx, qy, qz, qw = _quat_from_R(Twc[:3, :3])
                p.pose.orientation.x = float(qx)
                p.pose.orientation.y = float(qy)
                p.pose.orientation.z = float(qz)
                p.pose.orientation.w = float(qw)
                self.pub_pose.publish(p)

    rclpy.init()
    node = Bridge()
    try:
        rclpy.spin(node)
    finally:
        node.slam.flush()
        rclpy.shutdown()


if __name__ == "__main__":
    main()
