"""Tracking states (port of ``TrackState`` in
``orb_slam2_ros2_tpu/pipeline/tracking.py``; reference Tracking.h:12-18):
NOT_IMAGE_YET → NOT_INITING → OK ⇄ LOST."""

from __future__ import annotations

import enum


class TrackState(enum.Enum):
    NOT_IMAGE_YET = 0
    NOT_INITING = 1
    OK = 2
    LOST = 3
