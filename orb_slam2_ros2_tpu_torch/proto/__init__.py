"""The reference's map schema (``orbslam2.MapData``), a byte-for-byte copy of
``orb_slam2_ros2_tpu/proto/``: both packages register the same serialized
file ``orbslam2_map.proto`` in protobuf's default pool, so they share one
``MapData`` class in a process that imports both.  Needs ``google.protobuf``."""

from .orbslam2_map_pb2 import MapData  # noqa: F401
