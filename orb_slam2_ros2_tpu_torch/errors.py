"""Exception hierarchy + structured logging.

Mirrors the reference's error taxonomy (reference include/ORB_SLAM2/Error.h:
13-100 — FeatureLess, FileNotOpen, ImageSize, Thread, EPnP exceptions that
RCLCPP-log on construction).  Thread/EPnP failure classes have no analogue
here (no threads; RANSAC is fixed-budget and reports counts instead of
throwing); tracking failure is a state, not an exception
(pipeline.tracking.TrackState.LOST), matching the reference's LOST flag.
"""

from __future__ import annotations

import logging

log = logging.getLogger("orb_slam2_ros2_tpu_torch")


class SLAMError(Exception):
    """Base class; logs on construction like the reference's ORBSlam2Error."""

    def __init__(self, msg: str):
        super().__init__(msg)
        log.error("%s: %s", type(self).__name__, msg)


class FileNotOpenError(SLAMError):
    """Config / vocabulary / map file could not be read (Error.h FileNotOpen)."""


class ImageSizeError(SLAMError):
    """Input image does not match the configured camera size (Error.h ImageSize)."""


class FeatureLessError(SLAMError):
    """Too few features to initialize or continue (Error.h FeatureLess)."""
