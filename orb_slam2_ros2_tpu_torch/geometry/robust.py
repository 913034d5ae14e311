"""Robust-loss utilities shared by the solvers (port of
``orb_slam2_ros2_tpu/geometry/robust.py``): g2o Huber kernels with δ² =
5.991 (mono) / 7.815 (stereo) and information 1/σ² from the keypoint octave
(reference: src/Optimizer.cc:1084-1086, edge setup at :70-117)."""

from __future__ import annotations

import torch


def huber_weight(chi2: torch.Tensor, delta2) -> torch.Tensor:
    """IRLS weight for the Huber loss given squared error ``chi2``: 1 inside
    δ, δ/|e| beyond."""
    chi2 = torch.clamp(chi2, min=1e-12)
    return torch.clamp(torch.sqrt(delta2 / chi2), max=1.0)


def octave_inv_sigma2(octave: torch.Tensor, scale_factor: float, n_levels: int) -> torch.Tensor:
    """Per-keypoint information 1/σ² = 1/scale^(2·octave) (reference
    Optimizer.cc:74-76); ``n_levels`` is unused, as in the JAX version."""
    del n_levels
    sigma2 = torch.pow(torch.tensor(scale_factor * scale_factor, dtype=torch.float32,
                                    device=octave.device), octave.float())
    return 1.0 / sigma2


def chi2_gate(err2_weighted: torch.Tensor, chi2_th: float) -> torch.Tensor:
    """Inlier mask: weighted squared error under the χ² threshold
    (Optimizer.cc:144-171)."""
    return err2_weighted < chi2_th
