"""Camera routes: ground-truth Twc poses [n, 4, 4] f32, x right, y down,
z forward, in metres of the world as the cell sees it.

``drive`` is a frozen copy of ``io/synthetic.py``'s ``trajectory`` with a
phase for the gentle yaw (phase 0 gives the original's poses); ``handheld``
and ``circuits`` are the benchmark's own.  Each takes the route's parameters from the traffic file
and ``phase``, drawn from the run's seed."""

from __future__ import annotations

import numpy as np


def _yaw(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def drive(n: int, *, speed_m: float = 0.8, yaw_rate_rad: float = 0.002, yaw_freq: float = 0.05,
          phase: float = 0.0, start=(0.0, 0.0, 0.0), centre_heading: bool = False, **_) -> np.ndarray:
    """Forward motion at ``speed_m`` a frame with a gentle sinusoidal yaw.
    The heading's sum of yaw steps has a mean of its own (0.04 rad for the
    original); ``centre_heading`` starts the route turned against it, so a
    long drive runs straight down the box instead of into its wall."""
    poses = []
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = start
    if centre_heading:
        heading = np.cumsum(yaw_rate_rad * np.sin(np.arange(n) * yaw_freq + phase))
        T[:3, :3] = _yaw(-float(heading.mean()))
    for i in range(n):
        poses.append(T.copy())
        step = np.eye(4, dtype=np.float32)
        step[:3, :3] = _yaw(yaw_rate_rad * np.sin(i * yaw_freq + phase))
        step[:3, 3] = [0.0, 0.0, speed_m]
        T = T @ step
    return np.stack(poses)


def handheld(n: int, *, speed_m: float, mean_turn_deg: float, yaw_period_frames: int,
             phase: float = 0.0, start=(0.0, 0.0, 0.0), **_) -> np.ndarray:
    """A slow walk along z at ``speed_m`` a frame, looking around: the yaw
    swings as A·sin(2πi/P + phase), with A set so that the mean turn a frame,
    4A/P, is ``mean_turn_deg``.  Never revisits a place."""
    amp = np.deg2rad(mean_turn_deg) * yaw_period_frames / 4.0
    poses = []
    for i in range(n):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = _yaw(amp * np.sin(2.0 * np.pi * i / yaw_period_frames + phase))
        T[:3, 3] = np.asarray(start, np.float32) + np.array([0.0, 0.0, speed_m * i], np.float32)
        poses.append(T)
    return np.stack(poses)


def circuits(n: int, *, speed_m: float, turn_speed_m: float, radius_m: float, first_straight_m: float,
             straight_m: float, start=(0.0, 0.0, 0.0), **_) -> np.ndarray:
    """A chain of circuits: a straight, then once around a circle of
    ``radius_m`` turning right (a regular polygon of ``turn_speed_m`` sides,
    so it closes exactly: it rejoins the straight at its entry point with the
    same heading), then the next straight into new territory, and so on.
    The first straight is ``first_straight_m`` long, the later ones
    ``straight_m``."""
    n_turn = int(round(2.0 * np.pi * radius_m / turn_speed_m))
    d_turn = 2.0 * np.pi * radius_m / n_turn
    steps = []   # (forward metres, yaw after the step) a frame
    seg = 0
    while len(steps) < n:
        length = first_straight_m if seg == 0 else straight_m
        steps += [(speed_m, 0.0)] * int(round(length / speed_m))
        steps += [(d_turn, 2.0 * np.pi / n_turn)] * n_turn
        seg += 1
    poses = []
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = start
    for fwd, dyaw in steps[:n]:
        poses.append(T.copy())
        step = np.eye(4, dtype=np.float32)
        step[:3, :3] = _yaw(dyaw)
        step[:3, 3] = [0.0, 0.0, fwd]
        T = T @ step
    return np.stack(poses)


ROUTES = {"drive": drive, "handheld": handheld, "circuits": circuits}

