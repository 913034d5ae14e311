"""SE(3) / Sim(3), the camera model, triangulation and robust kernels."""

from . import se3, sim3, camera, triangulate, robust  # noqa: F401
