"""Dense direct RGB-D odometry: residuals, Jacobians, normal equations.

Port of `onepiece_tpu/ops/dense_odometry.py`. Every source pixel's 3D point
is transformed by the current pose, projected into the target, and the
target's intensity, gradients and depth are bilinearly sampled (a gather
warp); a depth-consistency gate plays the role of a z-buffer.

  E = (1 - lambda) sum r_I^2 + lambda sum r_Z^2
  r_I = I_tgt(pi(T p)) - I_src(x),   r_Z = Z_tgt(pi(T p)) - [T p]_z

Pose update is left-multiplicative, T <- exp(xi) T.

`normal_equations` runs the hand-written CUDA kernel
(`csrc/dense_normal_eq.cu`) on CUDA tensors and `normal_equations_reference`
on CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..geometry import se3
from . import image as image_ops


class TermData(NamedTuple):
    """Per-level target-side data, channels-first as the kernel reads it."""

    planes: torch.Tensor  # (6, H, W): gray, dx, dy, depth, zdx, zdy

    @property
    def gray(self) -> torch.Tensor:
        return self.planes[0]

    @property
    def dx(self) -> torch.Tensor:
        return self.planes[1]

    @property
    def dy(self) -> torch.Tensor:
        return self.planes[2]

    @property
    def depth(self) -> torch.Tensor:
        return self.planes[3]

    @property
    def zdx(self) -> torch.Tensor:
        return self.planes[4]

    @property
    def zdy(self) -> torch.Tensor:
        return self.planes[5]


class NormalEquations(NamedTuple):
    JTJ: torch.Tensor  # (6, 6)
    JTr: torch.Tensor  # (6,)
    cost: torch.Tensor  # () weighted SSE
    num_inliers: torch.Tensor  # () float


def build_term_data(
    gray: torch.Tensor, depth: torch.Tensor, sobel_scale: float = 0.125
) -> TermData:
    """Gradients of one target pyramid level. Depth gradients are zeroed
    wherever the 3x3 Sobel window touches an invalid (0) depth, so validity
    edges fabricate no multi-meter gradients."""
    dx, dy = image_ops.sobel(gray)
    zdx, zdy = image_ops.sobel(depth)
    interior = image_ops.box_sum3((depth > 0).to(gray.dtype)) > 8.5  # all 9 taps valid
    zdx = torch.where(interior, zdx, 0.0)
    zdy = torch.where(interior, zdy, 0.0)
    return TermData(
        torch.stack(
            [gray, dx * sobel_scale, dy * sobel_scale, depth, zdx * sobel_scale, zdy * sobel_scale]
        )
    )


def _stream_weights(lambda_depth: float, term: str) -> tuple[float, float]:
    """Squared weights of the photometric and geometric streams, rounded in
    float32 as the JAX package computes them (sqrt, then squared)."""
    if term == "photo":
        return 1.0, 0.0
    if term == "depth":
        return 0.0, 1.0
    if term != "hybrid":
        raise ValueError(f"unknown term {term!r}")
    lam = np.float32(lambda_depth)
    w_i = np.sqrt(np.maximum(np.float32(1.0) - lam, np.float32(0.0)))
    w_z = np.sqrt(np.maximum(lam, np.float32(0.0)))
    return float(w_i * w_i), float(w_z * w_z)


def _twist(p: tuple[torch.Tensor, ...], g: tuple[torch.Tensor, ...]) -> torch.Tensor:
    """Row g = dr/dp mapped through dp/dxi = [I | -[p]_x]: [g | p x g], (N, 6)."""
    px, py, pz = p
    g0, g1, g2 = g
    return torch.stack(
        [g0, g1, g2, py * g2 - pz * g1, pz * g0 - px * g2, px * g1 - py * g0], dim=-1
    )


def normal_equations_reference(
    T: torch.Tensor,
    src_xyz: torch.Tensor,  # (N, 3) source camera-frame points
    src_gray: torch.Tensor,  # (N,)
    src_valid: torch.Tensor,  # (N,) bool
    tgt: TermData,
    fx: float, fy: float, cx: float, cy: float,
    lambda_depth: float,
    depth_diff_max: float,
    term: str = "hybrid",
    huber_delta: float = 0.0,
) -> NormalEquations:
    """Plain PyTorch version: one linearisation -> 6x6 normal equations.

    term: 'photo' | 'depth' | 'hybrid'; `huber_delta` > 0 adds Huber IRLS
    weights. The kernel and `normal_equations` take the hybrid term without
    Huber weights only; the other forms are here to hold the port against
    the JAX package's `normal_equations`. Per-pixel arithmetic runs in the kernel's operation order (elementwise,
    no matmul), so on the card both give bit-identical pixel terms."""
    x, y, zs = src_xyz.unbind(-1)
    px = T[0, 0] * x + T[0, 1] * y + T[0, 2] * zs + T[0, 3]
    py = T[1, 0] * x + T[1, 1] * y + T[1, 2] * zs + T[1, 3]
    z = T[2, 0] * x + T[2, 1] * y + T[2, 2] * zs + T[2, 3]
    zsafe = torch.where(z > 1e-6, z, 1.0)
    u = px / zsafe * fx + cx
    v = py / zsafe * fy + cy
    uv = torch.stack([u, v], dim=-1)

    g, ok_g = image_ops.bilinear_sample(tgt.gray, uv)
    gx, _ = image_ops.bilinear_sample(tgt.dx, uv)
    gy, _ = image_ops.bilinear_sample(tgt.dy, uv)
    zt, ok_z = image_ops.bilinear_sample(tgt.depth, uv, valid_zero=True)
    ztx, _ = image_ops.bilinear_sample(tgt.zdx, uv)
    zty, _ = image_ops.bilinear_sample(tgt.zdy, uv)

    r_i = g - src_gray
    r_z = zt - z
    valid = src_valid & ok_g & ok_z & (z > 1e-6) & (torch.abs(r_z) < depth_diff_max)

    inv_z = 1.0 / zsafe
    zero = torch.zeros_like(z)
    du = (fx * inv_z, zero, -fx * px * inv_z * inv_z)
    dv = (zero, fy * inv_z, -fy * py * inv_z * inv_z)
    p = (px, py, z)
    J_i = _twist(p, tuple(gx * a + gy * b for a, b in zip(du, dv)))
    g_z = [ztx * a + zty * b for a, b in zip(du, dv)]
    g_z[2] = g_z[2] - 1.0
    J_z = _twist(p, tuple(g_z))

    vf = valid.to(torch.float32)
    w_i, w_z = _stream_weights(lambda_depth, term)
    wi = vf * w_i
    wz = vf * w_z
    if huber_delta > 0.0:  # Huber IRLS weights on each residual stream
        wi = wi * torch.clamp(huber_delta / torch.clamp(r_i.abs(), min=1e-12), max=1.0)
        wz = wz * torch.clamp(huber_delta / torch.clamp(r_z.abs(), min=1e-12), max=1.0)

    J = torch.stack([J_i, J_z], dim=1)  # (N, 2, 6)
    r = torch.stack([r_i, r_z], dim=1)
    wgt = torch.stack([wi, wz], dim=1)
    JTJ = torch.einsum("nki,nk,nkj->ij", J, wgt, J)
    JTr = torch.einsum("nki,nk,nk->i", J, wgt, r)
    cost = torch.einsum("nk,nk->", wgt, r * r)
    return NormalEquations(JTJ, JTr, cost, torch.sum(vf))


# pixels per CTA of the kernel's first pass (256 threads x 4 pixels)
_PIXELS_PER_CTA = 1024


def _normal_equations_cuda(
    T, src_xyz, src_gray, src_valid, tgt, fx, fy, cx, cy, lambda_depth, depth_diff_max,
) -> NormalEquations:
    dev = src_xyz.device
    n = src_xyz.shape[0]
    planes = tgt.planes
    req = _build.require
    req(src_xyz, "src_xyz", torch.float32, (n, 3), dev)
    req(src_gray, "src_gray", torch.float32, (n,), dev)
    req(src_valid, "src_valid", torch.bool, (n,), dev)
    req(planes, "tgt.planes", torch.float32, (6, None, None), dev)
    req(T, "T", torch.float32, (4, 4), dev)
    _, h, w = planes.shape
    wi, wz = _stream_weights(lambda_depth, "hybrid")
    num_blocks = max(1, -(-n // _PIXELS_PER_CTA))
    partials = torch.empty((num_blocks, 29), dtype=torch.float32, device=dev)
    out = torch.empty(44, dtype=torch.float32, device=dev)
    err = _build.library().dense_normal_eq(
        src_xyz.data_ptr(), src_gray.data_ptr(), src_valid.data_ptr(), n,
        planes.data_ptr(), h, w, T.data_ptr(), fx, fy, cx, cy, wi, wz, depth_diff_max,
        partials.data_ptr(), num_blocks, out.data_ptr(), _build.stream_handle(src_xyz),
    )
    _build.check(err, _build.DENSE_NORMAL_EQ)
    _build.DENSE_NORMAL_EQ.launches += 1
    return NormalEquations(out[:36].view(6, 6), out[36:42], out[42], out[43])


def normal_equations(
    T: torch.Tensor,
    src_xyz: torch.Tensor,
    src_gray: torch.Tensor,
    src_valid: torch.Tensor,
    tgt: TermData,
    fx: float, fy: float, cx: float, cy: float,
    lambda_depth: float,
    depth_diff_max: float,
) -> NormalEquations:
    """One linearisation of the hybrid term without Huber weights: the CUDA
    kernel on CUDA tensors, the plain version on CPU tensors."""
    args = (T, src_xyz, src_gray, src_valid, tgt, fx, fy, cx, cy, lambda_depth, depth_diff_max)
    if src_xyz.is_cuda:
        return _normal_equations_cuda(*args)
    if src_xyz.device.type == "cpu":
        return normal_equations_reference(*args)
    raise ValueError(f"normal_equations: unsupported device {src_xyz.device}")


def solve_and_update(
    T: torch.Tensor, ne: NormalEquations, damping: float = 1e-6
) -> torch.Tensor:
    """Gauss-Newton step: solve (JTJ + damp I) xi = -JTr, T <- exp(xi) T.

    No-op when the system is degenerate. `solve_ex` reports a singular
    system in `info` instead of raising, so the host never waits on it."""
    A = ne.JTJ + damping * torch.eye(6, dtype=ne.JTJ.dtype, device=ne.JTJ.device)
    xi, info = torch.linalg.solve_ex(A, -ne.JTr)
    ok = torch.isfinite(xi).all() & (ne.num_inliers > 6) & (info == 0)
    xi = torch.where(ok, xi, 0.0)
    return se3.se3_exp(xi) @ T
