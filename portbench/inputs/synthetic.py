"""The benchmark's frozen input generator: a copy of the port's synthetic
renderer (`onepiece_tpu_torch/utils/synthetic.py`: the scene, the sphere
tracer, `loop_trajectory`) and of its sensor model
(`corrupt_sequence`), so that no later change to the program changes what
the benchmark feeds it.

Two changes of form, none of result: `render_batch` traces a batch of poses
in one call (the same per-pixel operations as `render`, so a batch of one
gives `render`'s frame), and `corrupt_batch` applies the sensor model on
the frames' device from the same numpy draws as `corrupt_sequence`, with
the same float32 (and, for the holes, float64) arithmetic, so its frames
are `corrupt_sequence`'s bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Scene(NamedTuple):
    sphere_center: torch.Tensor  # (S, 3)
    sphere_radius: torch.Tensor  # (S,)
    sphere_albedo: torch.Tensor  # (S,)
    box_center: torch.Tensor  # (B, 3)
    box_half: torch.Tensor  # (B, 3)
    box_albedo: torch.Tensor  # (B,)
    plane: torch.Tensor  # (P, 4): sdf = n.x + d
    plane_albedo: torch.Tensor  # (P,)


def default_scene(device="cpu") -> Scene:
    """The port's room: floor and walls, boxes, spheres."""

    def t(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    return Scene(
        sphere_center=t([[0.4, 0.1, 2.0], [-0.5, 0.3, 2.6], [0.1, -0.45, 1.6], [0.9, -0.2, 2.9]]),
        sphere_radius=t([0.30, 0.35, 0.22, 0.28]),
        sphere_albedo=t([0.9, 0.6, 0.75, 0.5]),
        box_center=t([[-0.8, 0.45, 2.1], [0.0, 0.55, 2.9], [0.85, 0.35, 1.9]]),
        box_half=t([[0.25, 0.25, 0.25], [0.5, 0.15, 0.3], [0.2, 0.35, 0.2]]),
        box_albedo=t([0.8, 0.45, 0.65]),
        plane=t([
            [0.0, -1.0, 0.0, 0.8],
            [0.0, 0.0, -1.0, 3.6],
            [1.0, 0.0, 0.0, 1.8],
            [-1.0, 0.0, 0.0, 1.8],
        ]),
        plane_albedo=t([0.55, 0.85, 0.7, 0.4]),
    )


def _distances(scene: Scene, p: torch.Tensor) -> torch.Tensor:
    d_s = torch.linalg.norm(p[..., None, :] - scene.sphere_center, dim=-1) - scene.sphere_radius
    q = torch.abs(p[..., None, :] - scene.box_center) - scene.box_half
    d_b = torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1) + torch.clamp(torch.amax(q, dim=-1), max=0.0)
    d_p = p @ scene.plane[:, :3].T + scene.plane[:, 3]
    return torch.cat([d_s, d_b, d_p], dim=-1)


def scene_sdf(scene: Scene, p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    dists = _distances(scene, p)
    albedos = torch.cat([scene.sphere_albedo, scene.box_albedo, scene.plane_albedo])
    return torch.amin(dists, dim=-1), albedos[torch.argmin(dists, dim=-1)]


def _sdf_normal(scene: Scene, p: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    grads = []
    for e in torch.eye(3, dtype=p.dtype, device=p.device) * eps:
        grads.append(torch.amin(_distances(scene, p + e), dim=-1) - torch.amin(_distances(scene, p - e), dim=-1))
    n = torch.stack(grads, dim=-1)
    return n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-9)


def render_batch(
    scene: Scene,
    T_wc: torch.Tensor,  # (N, 4, 4) camera-to-world poses
    fx: float, fy: float, cx: float, cy: float,
    height: int,
    width: int,
    num_steps: int = 64,
    max_depth: float = 8.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sphere-trace N frames on T_wc's device: (depth (N, H, W) metres,
    gray (N, H, W) in [0, 1]); misses give depth 0."""
    dev = T_wc.device
    v = torch.arange(height, dtype=torch.float32, device=dev)[:, None].expand(height, width)
    u = torch.arange(width, dtype=torch.float32, device=dev)[None, :].expand(height, width)
    dirs_cam = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], dim=-1)
    origin = T_wc[:, None, None, :3, 3]  # (N, 1, 1, 3)
    # per frame dirs_cam @ R.T, as `render` computes it
    dirs = torch.stack([dirs_cam @ T[:3, :3].T for T in T_wc])  # (N, H, W, 3)
    dir_len = torch.linalg.norm(dirs, dim=-1)
    t = torch.full(dirs.shape[:3], 0.05, dtype=torch.float32, device=dev)
    for _ in range(num_steps):
        d = torch.amin(_distances(scene, origin + t[..., None] * dirs), dim=-1)
        t = t + d / dir_len
    p = origin + t[..., None] * dirs
    d_final, albedo = scene_sdf(scene, p)
    hit = (torch.abs(d_final) < 5e-3) & (t < max_depth) & (t > 0.05)
    depth = torch.where(hit, t, 0.0)
    n = _sdf_normal(scene, p)
    light = torch.tensor([0.35, -0.6, -0.7], dtype=torch.float32, device=dev)
    light = light / torch.linalg.norm(light)
    lambert = torch.clamp(torch.sum(n * light, dim=-1), 0.0, 1.0)
    tex = 0.75 + 0.25 * torch.sin(9.0 * p[..., 0]) * torch.sin(7.0 * p[..., 1]) * torch.sin(11.0 * p[..., 2])
    gray = torch.where(hit, albedo * (0.3 + 0.7 * lambert) * tex, 0.0)
    return depth, gray


# --- SE(3) exp, as the port's geometry/se3.py computes it (float32) --------

_EPS = 1e-8


def _skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist (..., 6) [rho, phi] -> (..., 4, 4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    taylor = theta2 < 1e-8
    a = torch.where(taylor, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(taylor, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS))
    c = torch.where(taylor, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta + _EPS * _EPS * _EPS))
    K = _skew(phi)
    eye = torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)
    R = eye + a[..., None, None] * K + b[..., None, None] * (K @ K)
    V = eye + b[..., None, None] * K + c[..., None, None] * (K @ K)
    t = (V @ rho[..., None])[..., 0]
    batch = xi.shape[:-1]
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:].expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def _poses_from_twists(xis: list[np.ndarray]) -> np.ndarray:
    return se3_exp(torch.from_numpy(np.stack(xis).astype(np.float32))).numpy()


def loop_trajectory(num_frames: int, radius: float = 0.35) -> np.ndarray:
    """The port's closed loop, (N, 4, 4): every motion term is periodic."""
    xis = []
    for i in range(num_frames):
        ang = 2.0 * np.pi * i / num_frames
        xis.append(np.array([
            radius * np.sin(ang), 0.06 * np.sin(2 * ang), 0.18 * (1.0 - np.cos(ang)),
            0.08 * np.sin(2 * ang), 0.45 * np.sin(ang), 0.04 * np.sin(3 * ang),
        ], np.float32))
    return _poses_from_twists(xis)


TRAJECTORIES = {"loop": loop_trajectory}

# --- the sensor model (Kinect axial noise, dropout holes, gray noise) -------

DEPTH_NOISE_A = 0.0012  # m
DEPTH_NOISE_B = 0.0019  # m^-1
DEFAULT_HOLES = 10
GRAY_SIGMA = 0.01
HOLE_RADIUS = (4, 24)
DEPTH_SCALE = 5000.0


def corrupt_rgbd(rng: np.random.Generator, gray: np.ndarray, depth: np.ndarray, holes: int = DEFAULT_HOLES,
                 hole_radius: tuple[int, int] = HOLE_RADIUS, gray_sigma: float = GRAY_SIGMA,
                 contrast: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    """The port's `corrupt_rgbd`, on the host."""
    g = np.asarray(gray, np.float32)
    z = np.asarray(depth, np.float32)
    sig = DEPTH_NOISE_A + DEPTH_NOISE_B * np.square(np.maximum(z - 0.4, 0.0))
    zn = np.where(z > 0, z + rng.normal(size=z.shape).astype(np.float32) * sig, 0.0)
    h, w = z.shape
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(holes):
        cy_, cx_ = int(rng.integers(0, h)), int(rng.integers(0, w))
        ry_ = int(rng.integers(hole_radius[0], hole_radius[1]))
        rx_ = int(rng.integers(hole_radius[0], hole_radius[1]))
        mask = ((yy - cy_) / ry_) ** 2 + ((xx - cx_) / rx_) ** 2 <= 1.0
        zn = np.where(mask, 0.0, zn)
    if contrast != 1.0:
        g = np.float32(g.mean()) + contrast * (g - np.float32(g.mean()))
    gn = np.clip(g + rng.normal(size=g.shape).astype(np.float32) * gray_sigma, 0.0, 1.0)
    return gn.astype(np.float32), np.maximum(zn, 0.0).astype(np.float32)


def quantize_rgbd(gray, depth, depth_scale: float = DEPTH_SCALE):
    g8 = np.clip(np.asarray(gray) * 255.0, 0, 255).astype(np.uint8)
    d16 = np.clip(np.asarray(depth) * depth_scale, 0, 65535).astype(np.uint16)
    return g8.astype(np.float32) / 255.0, d16.astype(np.float32) / depth_scale


def corrupt_sequence(grays: np.ndarray, depths: np.ndarray, seed: int = 1000, quantize: bool = True,
                     **kw) -> tuple[np.ndarray, np.ndarray]:
    """The port's `corrupt_sequence` without a textureless segment: frame i
    draws from `default_rng(seed + i)`."""
    gs, ds = [], []
    for i in range(len(grays)):
        g, d = corrupt_rgbd(np.random.default_rng(seed + i), grays[i], depths[i], **kw)
        if quantize:
            g, d = quantize_rgbd(g, d)
        gs.append(g)
        ds.append(d)
    return np.stack(gs), np.stack(ds)


def _draws(seed: int, h: int, w: int, holes: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One frame's draws in `corrupt_rgbd`'s order: depth normals, holes
    (cy, cx, ry, rx), gray normals."""
    rng = np.random.default_rng(seed)
    nz = rng.normal(size=(h, w)).astype(np.float32)
    hs = []
    for _ in range(holes):
        cy_, cx_ = int(rng.integers(0, h)), int(rng.integers(0, w))
        ry_ = int(rng.integers(HOLE_RADIUS[0], HOLE_RADIUS[1]))
        rx_ = int(rng.integers(HOLE_RADIUS[0], HOLE_RADIUS[1]))
        hs.append((cy_, cx_, ry_, rx_))
    ng = rng.normal(size=(h, w)).astype(np.float32)
    return nz, np.asarray(hs, np.int64).reshape(holes, 4), ng


def corrupt_batch(grays: torch.Tensor, depths: torch.Tensor, seed: int,
                  holes: int = DEFAULT_HOLES) -> tuple[torch.Tensor, torch.Tensor]:
    """`corrupt_sequence(grays, depths, seed)` (quantised, contrast 1) on the
    frames' device, (N, H, W) float32 each; frame i draws from
    `default_rng(seed + i)` as there."""
    n, h, w = depths.shape
    dev = depths.device
    nzs, hss, ngs = zip(*(_draws(seed + i, h, w, holes) for i in range(n)))
    nz = torch.from_numpy(np.stack(nzs)).to(dev)
    ng = torch.from_numpy(np.stack(ngs)).to(dev)
    hs = torch.from_numpy(np.stack(hss)).to(dev)  # (N, holes, 4)
    z = depths
    sig = DEPTH_NOISE_A + DEPTH_NOISE_B * torch.square(torch.clamp(z - 0.4, min=0.0))
    zn = torch.where(z > 0, z + nz * sig, 0.0)
    yy = torch.arange(h, device=dev, dtype=torch.int64)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.int64)[None, :]
    for k in range(holes):
        cy_, cx_, ry_, rx_ = (hs[:, k, j, None, None] for j in range(4))
        # numpy divides the int64 offsets by the int radius in float64
        mask = ((yy - cy_).double() / ry_.double()) ** 2 + ((xx - cx_).double() / rx_.double()) ** 2 <= 1.0
        zn = torch.where(mask, 0.0, zn)
    gn = torch.clamp(grays + ng * GRAY_SIGMA, 0.0, 1.0)
    zn = torch.clamp(zn, min=0.0)
    # quantise as the TUM files store it: uint8 gray, uint16 depth; true
    # divisions (a tensor divisor), as numpy's
    g8 = torch.clamp(gn * 255.0, 0, 255).to(torch.uint8).to(torch.float32)
    d16 = torch.clamp(zn * DEPTH_SCALE, 0, 65535).to(torch.int32).to(torch.float32)
    return (g8 / torch.full((), 255.0, device=dev), d16 / torch.full((), DEPTH_SCALE, device=dev))
