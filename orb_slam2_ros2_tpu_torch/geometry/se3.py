"""SE(3) rigid transforms as batched torch tensors.

Port of ``orb_slam2_ros2_tpu/geometry/se3.py``.  A pose is a plain ``f32[..., 4, 4]`` tensor; the tangent
convention is ``xi = [rho, phi]`` with ``exp(xi) = [[exp(phi^), V rho], [0, 1]]``
(g2o's SE3Quat ordering, reference src/Optimizer.cc:628-718).
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def identity(batch: tuple = (), *, device) -> torch.Tensor:
    """Identity poses ``[*batch, 4, 4]`` on ``device``."""
    return torch.eye(4, dtype=torch.float32, device=device).expand(*batch, 4, 4).clone()


def from_Rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Build [..., 4, 4] from R [..., 3, 3] and t [..., 3]."""
    batch = R.shape[:-2]
    T = torch.zeros((*batch, 4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3].fill_(1.0)  # a scalar set-item would copy from the host
    return T


def R_of(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def t_of(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form SE3 inverse: [R^T, -R^T t]."""
    Rt = R_of(T).transpose(-1, -2)
    return from_Rt(Rt, -torch.einsum("...ij,...j->...i", Rt, t_of(T)))


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def apply(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Transform points p [..., 3] by T [..., 4, 4] (broadcasting)."""
    return torch.einsum("...ij,...j->...i", R_of(T), p) + t_of(T)


def hat(phi: torch.Tensor) -> torch.Tensor:
    """so(3) hat: [..., 3] -> [..., 3, 3] skew matrix."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [..., 3] -> [..., 3, 3].  Series expansion near zero."""
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2 + _EPS)
    K = hat(phi)
    K2 = K @ K
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    I = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return I + a * K + b * K2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 3], for angles in [0, π): θ = atan2(‖w‖, tr − 1)
    with w the skew part (‖w‖ = 2 sin θ), well-conditioned away from π."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    w = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        dim=-1,
    )
    w_norm = torch.sqrt(torch.sum(w * w, dim=-1) + 1e-24)  # = 2 sin θ
    theta = torch.atan2(w_norm, trace - 1.0)
    # θ/(2 sin θ) with the series 1/2 + θ²/12 near zero
    scale = torch.where(w_norm < 1e-6, 0.5 + theta * theta / 12.0,
                        theta / torch.clamp(w_norm, min=1e-12))
    return w * scale[..., None]


def _V(phi: torch.Tensor) -> torch.Tensor:
    """Left Jacobian of SO(3): V such that exp([rho,phi]) translation = V rho."""
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2 + _EPS)
    K = hat(phi)
    K2 = K @ K
    small = theta2 < 1e-8
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (theta2 * theta))
    I = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return I + b * K + c * K2


def exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exp: [..., 6] (rho, phi) -> [..., 4, 4]."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    t = torch.einsum("...ij,...j->...i", _V(phi), rho)
    return from_Rt(R, t)


def log(T: torch.Tensor) -> torch.Tensor:
    """se(3) log: [..., 4, 4] -> [..., 6] (rho, phi).  Small angles take
    ``so3_log``'s series branch; ``V`` is inverted by ``inv_ex`` (no host
    check of its info)."""
    phi = so3_log(R_of(T))
    Vinv, _ = torch.linalg.inv_ex(_V(phi))
    rho = torch.einsum("...ij,...j->...i", Vinv, t_of(T))
    return torch.cat([rho, phi], dim=-1)


def normalize(T: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize the rotation block by a quaternion round trip."""
    from ..solvers.linalg_small import quat_to_rot, rot_to_quat

    q = rot_to_quat(R_of(T))
    return from_Rt(quat_to_rot(q), t_of(T))
