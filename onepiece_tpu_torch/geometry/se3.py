"""SE(3) / SO(3) Lie-group math on torch tensors, batched-first.

Port of `onepiece_tpu/geometry/se3.py`. Twist convention ``xi = (rho, phi)``
(translation first), ``exp(xi) = [exp(phi_x) | V(phi) rho]``. Every function
keeps its input's dtype (float32 or float64) and device.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [v]_x: (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def _eye3_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle (..., 3) -> rotation (..., 3, 3), Taylor-guarded."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    use_taylor = theta2 < 1e-8
    a = torch.where(use_taylor, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(
        use_taylor, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS)
    )
    K = skew(phi)
    return _eye3_like(K) + a[..., None, None] * K + b[..., None, None] * (K @ K)


def _so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """V(phi), the SO(3) left Jacobian used by se3_exp: (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    use_taylor = theta2 < 1e-8
    b = torch.where(
        use_taylor, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS)
    )
    c = torch.where(
        use_taylor,
        1.0 / 6.0 - theta2 / 120.0,
        (theta - torch.sin(theta)) / (theta2 * theta + _EPS * _EPS * _EPS),
    )
    K = skew(phi)
    return _eye3_like(K) + b[..., None, None] * K + c[..., None, None] * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) -> axis-angle (..., 3), guarded at theta ~ 0
    (w (0.5 + theta^2 / 12), w the antisymmetric part) and at theta ~ pi
    (the axis from the diagonal, its signs from the off-diagonal sums)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    small = theta < 1e-4
    near_pi = theta > torch.pi - 1e-3
    scale = torch.where(small, 0.5 + theta * theta / 12.0,
                        theta / (2.0 * torch.where(small | near_pi, 1.0, torch.sin(theta))))
    phi_generic = w * scale[..., None]
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis = torch.sqrt(torch.clamp((diag - cos_theta[..., None]) / torch.clamp(1.0 - cos_theta[..., None], min=1e-9),
                                  0.0, 1.0))
    sy = torch.where(R[..., 0, 1] + R[..., 1, 0] >= 0.0, 1.0, -1.0)
    sz = torch.where(R[..., 0, 2] + R[..., 2, 0] >= 0.0, 1.0, -1.0)
    axis = axis * torch.stack([torch.ones_like(sy), sy, sz], dim=-1)
    axis = axis / torch.clamp(torch.linalg.vector_norm(axis, dim=-1, keepdim=True), min=1e-9)
    return torch.where(near_pi[..., None], axis * theta[..., None], phi_generic)


def _so3_left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    """V(phi)^-1: (..., 3) -> (..., 3, 3), Taylor-guarded near 0."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    use_taylor = theta2 < 1e-8
    half = 0.5 * theta
    cot_term = torch.where(
        use_taylor,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.where(use_taylor, 1.0, torch.sin(half))) / (theta2 + _EPS * _EPS),
    )
    K = skew(phi)
    return _eye3_like(K) - 0.5 * K + cot_term[..., None, None] * (K @ K)


def make_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 4, 4) from (..., 3, 3) and (..., 3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    top = torch.cat([R.expand(batch + (3, 3)), t.expand(batch + (3,))[..., None]], dim=-1)
    # the [0, 0, 0, 1] row made on the device: writing a Python scalar into
    # a CUDA tensor element would copy from the host and wait for it
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:].expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist (..., 6) [rho, phi] -> homogeneous transform (..., 4, 4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    t = (_so3_left_jacobian(phi) @ rho[..., None])[..., 0]
    return make_T(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """Homogeneous transform (..., 4, 4) -> twist (..., 6) [rho, phi]."""
    phi = so3_log(T[..., :3, :3])
    rho = (_so3_left_jacobian_inv(phi) @ T[..., :3, 3, None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def inverse_T(T: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(3) inverse: [R^T | -R^T t]."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make_T(Rt, -(Rt @ T[..., :3, 3, None])[..., 0])


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to (..., N, 3) -> (..., N, 3)."""
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def transform_normals(T: torch.Tensor, normals: torch.Tensor) -> torch.Tensor:
    """Rotate normals (..., N, 3) by the rotation part of T (rigid, so R^-T = R)."""
    return normals @ T[..., :3, :3].transpose(-1, -2)
