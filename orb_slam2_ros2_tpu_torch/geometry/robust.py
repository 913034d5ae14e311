"""Robust-loss weight (port of ``huber_weight`` in
``orb_slam2_ros2_tpu/geometry/robust.py``): g2o Huber kernels with δ² =
5.991 (mono) / 7.815 (stereo) (reference: src/Optimizer.cc:1084-1086)."""

from __future__ import annotations

import torch


def huber_weight(chi2: torch.Tensor, delta2) -> torch.Tensor:
    """IRLS weight for the Huber loss given squared error ``chi2``: 1 inside
    δ, δ/|e| beyond."""
    chi2 = torch.clamp(chi2, min=1e-12)
    return torch.clamp(torch.sqrt(delta2 / chi2), max=1.0)
