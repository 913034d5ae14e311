"""Sim(3) similarity transforms.

Port of ``orb_slam2_ros2_tpu/geometry/sim3.py`` (reference ``Sim3Ret``:
include/ORB_SLAM2/Sim3Solver.h:15-48, src/Sim3Solver.cc:261-271).  A Sim3 is
a NamedTuple ``(R [..., 3, 3], t [..., 3], s [...])`` with inverse,
composition and the action on points ``S(p) = s·R·p + t``, plus exp/log on
sim(3) (the closed-form W matrix, with series forms near θ = 0 and σ = 0).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import se3

_EPS_SQ = 1e-10
_EPS = 1e-5


class Sim3(NamedTuple):
    R: torch.Tensor  # [..., 3, 3]
    t: torch.Tensor  # [..., 3]
    s: torch.Tensor  # [...]


def identity(batch: tuple = (), *, device) -> Sim3:
    return Sim3(
        R=torch.eye(3, dtype=torch.float32, device=device).expand(*batch, 3, 3).clone(),
        t=torch.zeros((*batch, 3), dtype=torch.float32, device=device),
        s=torch.ones(batch, dtype=torch.float32, device=device),
    )


def from_se3(T: torch.Tensor, s=None) -> Sim3:
    if s is None:
        scale = torch.ones(T.shape[:-2], dtype=T.dtype, device=T.device)
    else:
        scale = torch.as_tensor(s, dtype=T.dtype, device=T.device)
    return Sim3(R=se3.R_of(T), t=se3.t_of(T), s=scale)


def to_se3(S: Sim3) -> torch.Tensor:
    """Drop scale into translation: [R, t/s] as SE3, the convention when
    corrected Sim3 poses are committed back to keyframes
    (src/Optimizer.cc:898-906)."""
    return se3.from_Rt(S.R, S.t / S.s[..., None])


def inverse(S: Sim3) -> Sim3:
    Rt = S.R.transpose(-1, -2)
    s_inv = 1.0 / S.s
    return Sim3(R=Rt, t=-s_inv[..., None] * torch.einsum("...ij,...j->...i", Rt, S.t), s=s_inv)


def compose(A: Sim3, B: Sim3) -> Sim3:
    """A ∘ B: (A∘B)(p) = A(B(p))."""
    return Sim3(
        R=A.R @ B.R,
        t=A.s[..., None] * torch.einsum("...ij,...j->...i", A.R, B.t) + A.t,
        s=A.s * B.s,
    )


def apply(S: Sim3, p: torch.Tensor) -> torch.Tensor:
    """Transform points p [..., 3]: s R p + t."""
    return S.s[..., None] * torch.einsum("...ij,...j->...i", S.R, p) + S.t


def _calc_W(phi: torch.Tensor, sigma: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """W such that exp([rho, phi, sigma]).t == W @ rho: W = A·K + B·K² + C·I
    with K = hat(phi), a branch-free select over the four (θ small / σ small)
    regimes.  Denominators are clamped, so every branch stays finite."""
    K = se3.hat(phi)
    K2 = K @ K
    theta_sq = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta_sq + _EPS_SQ)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    sigma_sq = sigma * sigma
    small_sig = sigma.abs() < _EPS
    small_th = theta_sq < _EPS_SQ * 10

    one = torch.ones_like(sigma)
    th_sq_c = torch.clamp(theta_sq, min=1e-10)
    sig_c = torch.where(sigma >= 0, torch.clamp(sigma, min=_EPS), torch.clamp(sigma, max=-_EPS))

    # σ small:
    C_s = one
    A_ss = 0.5 * one                      # θ small too
    B_ss = one / 6.0
    A_sl = (1.0 - cos_t) / th_sq_c        # θ large
    B_sl = (theta - sin_t) / (th_sq_c * theta)

    # σ large:
    C_l = (scale - 1.0) / sig_c
    A_ls = ((sigma - 1.0) * scale + 1.0) / (sig_c * sig_c)                # θ small
    B_ls = (scale * (0.5 * sigma_sq - sigma + 1.0) - 1.0) / (sig_c * sig_c * sig_c)
    a = scale * sin_t
    b = scale * cos_t
    c = torch.clamp(theta_sq + sigma_sq, min=1e-12)
    A_ll = (a * sigma + (1.0 - b) * theta) / (theta * c)                  # θ large
    B_ll = (C_l - ((b - 1.0) * sigma + a * theta) / c) / th_sq_c

    A = torch.where(small_sig, torch.where(small_th, A_ss, A_sl), torch.where(small_th, A_ls, A_ll))
    B = torch.where(small_sig, torch.where(small_th, B_ss, B_sl), torch.where(small_th, B_ls, B_ll))
    C = torch.where(small_sig, C_s, C_l)

    I = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return A[..., None, None] * K + B[..., None, None] * K2 + C[..., None, None] * I


def exp(xi: torch.Tensor) -> Sim3:
    """sim(3) exp.  xi = [rho(3), phi(3), sigma(1)] -> Sim3."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    scale = torch.exp(sigma)
    W = _calc_W(phi, sigma, scale)
    return Sim3(R=se3.so3_exp(phi), t=torch.einsum("...ij,...j->...i", W, rho), s=scale)


def log(S: Sim3) -> torch.Tensor:
    """sim(3) log: solve W rho = t with W rebuilt from (phi, sigma)."""
    from ..solvers.linalg_small import inv3

    phi = se3.so3_log(S.R)
    sigma = torch.log(S.s)
    W = _calc_W(phi, sigma, S.s)
    rho = torch.einsum("...ij,...j->...i", inv3(W), S.t)
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)
