"""Multi-device operation: the device mesh of the sharded solvers
(``mesh.py``)."""

from .mesh import Mesh, ba_mesh, default_devices, device_count, init_distributed, pad_points_for_mesh  # noqa: F401
