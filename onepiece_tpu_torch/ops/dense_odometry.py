"""Dense direct RGB-D odometry: residuals, Jacobians, normal equations.

Port of `onepiece_tpu/ops/dense_odometry.py`. Every source pixel's 3D point
is transformed by the current pose, projected into the target, and the
target's intensity, gradients and depth are bilinearly sampled (a gather
warp); a depth-consistency gate plays the role of a z-buffer.

  E = (1 - lambda) sum r_I^2 + lambda sum r_Z^2
  r_I = I_tgt(pi(T p)) - I_src(x),   r_Z = Z_tgt(pi(T p)) - [T p]_z

Pose update is left-multiplicative, T <- exp(xi) T.

`gauss_newton` takes the tracker's Gauss-Newton steps at one pyramid level:
on CUDA tensors one launch of the hand-written kernel
(`csrc/dense_normal_eq.cu`) per step, which linearises, solves, gates and
updates the pose on the device; on CPU tensors `gn_step_reference`, its
plain version, per step. `normal_equations` is the same kernel with the
update switched off (plain version `normal_equations_reference`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..geometry import se3
from . import image as image_ops


class TermData(NamedTuple):
    """Per-level target-side data, channels-last as the kernel reads it."""

    texels: torch.Tensor  # (H, W, 8): gray, dx, dy, depth, zdx, zdy, 0, 0

    @property
    def gray(self) -> torch.Tensor:
        return self.texels[..., 0]

    @property
    def dx(self) -> torch.Tensor:
        return self.texels[..., 1]

    @property
    def dy(self) -> torch.Tensor:
        return self.texels[..., 2]

    @property
    def depth(self) -> torch.Tensor:
        return self.texels[..., 3]

    @property
    def zdx(self) -> torch.Tensor:
        return self.texels[..., 4]

    @property
    def zdy(self) -> torch.Tensor:
        return self.texels[..., 5]


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
    pad = torch.zeros_like(gray)
    return TermData(
        torch.stack(
            [gray, dx * sobel_scale, dy * sobel_scale, depth, zdx * sobel_scale, zdy * sobel_scale,
             pad, pad],
            dim=-1,
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


# rows of the kernel's partial sums: its grid has at most 264 CTAs (two on
# each of the H100's 132 SMs); the C entry point checks the size
_PARTIAL_ROWS = 264
_N_TERMS = 29  # per CTA: 21 JTJ (upper triangle) + 6 JTr + cost + count
DAMPING = 1e-6


def _check_texels(tgt: TermData, dev) -> tuple[int, int]:
    _build.require(tgt.texels, "tgt.texels", torch.float32, (None, None, 8), dev)
    if tgt.texels.data_ptr() % 16:
        raise ValueError("tgt.texels: not 16-byte aligned")
    h, w, _ = tgt.texels.shape
    return h, w


def _launch_gn(T, src4, tgt, fx, fy, cx, cy, lambda_depth, depth_diff_max, update, iters):
    """Run the kernel `iters` times on the current stream; returns the 44
    floats of the last step's normal equations."""
    dev = src4.device
    _build.require(T, "T", torch.float32, (4, 4), dev)
    h, w = _check_texels(tgt, dev)
    wi, wz = _stream_weights(lambda_depth, "hybrid")
    partials = torch.empty((_PARTIAL_ROWS, _N_TERMS), dtype=torch.float32, device=dev)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)  # the kernel leaves it at 0
    out = torch.empty(44, dtype=torch.float32, device=dev)
    err = _build.library().dense_gn(
        src4.data_ptr(), src4.shape[0], tgt.texels.data_ptr(), h, w, T.data_ptr(),
        fx, fy, cx, cy, wi, wz, depth_diff_max, DAMPING, int(update), iters,
        partials.data_ptr(), _PARTIAL_ROWS, counter.data_ptr(), out.data_ptr(),
        _build.stream_handle(src4),
    )
    _build.check(err, _build.DENSE_NORMAL_EQ)
    _build.DENSE_NORMAL_EQ.launches += iters
    return out


def _as_ne(out: torch.Tensor) -> NormalEquations:
    return NormalEquations(out[:36].view(6, 6), out[36:42], out[42], out[43])


def _pack_source(src_xyz: torch.Tensor, src_gray: torch.Tensor) -> torch.Tensor:
    """(N, 4) x, y, z, gray: one 16-byte load per pixel in the kernel."""
    n = src_xyz.shape[0]
    _build.require(src_xyz, "src_xyz", torch.float32, (n, 3), src_xyz.device)
    _build.require(src_gray, "src_gray", torch.float32, (n,), src_xyz.device)
    return torch.cat([src_xyz, src_gray[:, None]], dim=1)


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
    kernel (update off) on CUDA tensors, the plain version on CPU tensors.

    The kernel reads a source point as valid where its z > 0; here an
    invalid point is passed to it with z = 0, and a point with z <= 0 is
    never valid on the card."""
    args = (T, src_xyz, src_gray, src_valid, tgt, fx, fy, cx, cy, lambda_depth, depth_diff_max)
    if src_xyz.is_cuda:
        _build.require(src_valid, "src_valid", torch.bool, (src_xyz.shape[0],), src_xyz.device)
        src4 = _pack_source(torch.where(src_valid[:, None], src_xyz, 0.0), src_gray)
        return _as_ne(_launch_gn(T, src4, tgt, fx, fy, cx, cy, lambda_depth, depth_diff_max,
                                 update=False, iters=1))
    if src_xyz.device.type == "cpu":
        return normal_equations_reference(*args)
    raise ValueError(f"normal_equations: unsupported device {src_xyz.device}")


def solve6_reference(A: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve the 6x6 system A x = b by LU with partial pivoting (the first
    row of the largest |pivot|), in float32, with the kernel's operations in
    the kernel's order. Returns (x, no pivot was exactly zero)."""
    n = 6
    A = A.clone()
    b = b.clone()
    rows = torch.arange(n, device=A.device)
    nonsingular = torch.ones((), dtype=torch.bool, device=A.device)
    for k in range(n):
        p = k + torch.argmax(A[k:, k].abs())
        swap = torch.where(rows == k, p, torch.where(rows == p, k, rows))
        A, b = A[swap], b[swap]
        piv = A[k, k]
        nonsingular = nonsingular & (piv != 0)
        lk = A[k + 1 :, k] / piv
        A[k + 1 :, k + 1 :] -= lk[:, None] * A[k, k + 1 :]
        b[k + 1 :] -= lk * b[k]
    x = torch.zeros_like(b)
    for i in reversed(range(n)):
        s = b[i]
        for j in range(i + 1, n):
            s = s - A[i, j] * x[j]
        x[i] = s / A[i, i]
    return x, nonsingular


def solve_and_update(
    T: torch.Tensor, ne: NormalEquations, damping: float = DAMPING
) -> torch.Tensor:
    """Gauss-Newton step: solve (JTJ + damp I) xi = -JTr, T <- exp(xi) T.

    No-op when the system is degenerate: xi not finite, 6 inliers or fewer,
    or an exactly zero pivot. Nothing here waits for the device."""
    A = ne.JTJ + damping * torch.eye(6, dtype=ne.JTJ.dtype, device=ne.JTJ.device)
    xi, nonsingular = solve6_reference(A, -ne.JTr)
    ok = torch.isfinite(xi).all() & (ne.num_inliers > 6) & nonsingular
    return torch.where(ok, se3.se3_exp(xi) @ T, T)


def gn_step_reference(
    T: torch.Tensor,
    src_xyz: torch.Tensor,
    src_gray: torch.Tensor,
    src_valid: torch.Tensor,
    tgt: TermData,
    fx: float, fy: float, cx: float, cy: float,
    lambda_depth: float,
    depth_diff_max: float,
) -> tuple[torch.Tensor, NormalEquations]:
    """Plain version of one kernel launch: (the updated T, the normal
    equations at the given T)."""
    ne = normal_equations_reference(
        T, src_xyz, src_gray, src_valid, tgt, fx, fy, cx, cy, lambda_depth, depth_diff_max)
    return solve_and_update(T, ne), ne


def gauss_newton_reference(
    T, src_xyz, src_gray, tgt, fx, fy, cx, cy, lambda_depth, depth_diff_max, iters,
) -> NormalEquations:
    """Plain version of `gauss_newton`: `iters` calls of `gn_step_reference`."""
    src_valid = src_xyz[:, 2] > 0
    ne = None
    for _ in range(iters):
        T_new, ne = gn_step_reference(
            T, src_xyz, src_gray, src_valid, tgt, fx, fy, cx, cy, lambda_depth, depth_diff_max)
        T.copy_(T_new)
    return ne


def gauss_newton(
    T: torch.Tensor,
    src_xyz: torch.Tensor,  # (N, 3) source camera-frame points; valid where z > 0
    src_gray: torch.Tensor,  # (N,)
    tgt: TermData,
    fx: float, fy: float, cx: float, cy: float,
    lambda_depth: float,
    depth_diff_max: float,
    iters: int,
) -> NormalEquations:
    """`iters` Gauss-Newton steps of the hybrid term at one pyramid level,
    updating T (4, 4) IN PLACE; returns the normal equations of the last
    step (at the pose before its update). `iters` >= 1.

    CUDA tensors: one kernel launch per step, all enqueued by one call, no
    host sync. CPU tensors: `gauss_newton_reference`."""
    if iters < 1:
        raise ValueError(f"gauss_newton: iters {iters} < 1")
    if src_xyz.is_cuda:
        src4 = _pack_source(src_xyz, src_gray)
        return _as_ne(_launch_gn(T, src4, tgt, fx, fy, cx, cy, lambda_depth, depth_diff_max,
                                 update=True, iters=iters))
    if src_xyz.device.type == "cpu":
        return gauss_newton_reference(
            T, src_xyz, src_gray, tgt, fx, fy, cx, cy, lambda_depth, depth_diff_max, iters)
    raise ValueError(f"gauss_newton: unsupported device {src_xyz.device}")
