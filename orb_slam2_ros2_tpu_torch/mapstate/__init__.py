"""The device-resident map and the local-mapping ops."""

from .map_state import MapState, empty_map  # noqa: F401
