"""Synthetic RGB-D frames by SDF sphere tracing, with exact ground-truth poses.

Port of `onepiece_tpu/utils/synthetic.py` (scene, renderer, trajectories,
and the numpy sensor-noise model `corrupt_rgbd` / `quantize_rgbd` /
`corrupt_sequence`):
a room of spheres, boxes and planes is sphere-traced from a known camera
trajectory, giving z-depth, a shaded textured gray image and exact poses.
The renderer runs on whatever device its pose tensor lives on.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import se3


class Scene(NamedTuple):
    """Sphere + box + plane primitive soup (SoA, fixed counts)."""

    sphere_center: torch.Tensor  # (S, 3)
    sphere_radius: torch.Tensor  # (S,)
    sphere_albedo: torch.Tensor  # (S,)
    box_center: torch.Tensor  # (B, 3)
    box_half: torch.Tensor  # (B, 3)
    box_albedo: torch.Tensor  # (B,)
    plane: torch.Tensor  # (P, 4): sdf = n.x + d
    plane_albedo: torch.Tensor  # (P,)


def default_scene(device="cpu") -> Scene:
    """A room-like scene: floor/walls + furniture-ish boxes + spheres."""

    def t(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    return Scene(
        sphere_center=t([[0.4, 0.1, 2.0], [-0.5, 0.3, 2.6], [0.1, -0.45, 1.6], [0.9, -0.2, 2.9]]),
        sphere_radius=t([0.30, 0.35, 0.22, 0.28]),
        sphere_albedo=t([0.9, 0.6, 0.75, 0.5]),
        box_center=t([[-0.8, 0.45, 2.1], [0.0, 0.55, 2.9], [0.85, 0.35, 1.9]]),
        box_half=t([[0.25, 0.25, 0.25], [0.5, 0.15, 0.3], [0.2, 0.35, 0.2]]),
        box_albedo=t([0.8, 0.45, 0.65]),
        # floor y=+0.8 (y down), back wall z=3.6, side walls x=+-1.8
        plane=t([
            [0.0, -1.0, 0.0, 0.8],
            [0.0, 0.0, -1.0, 3.6],
            [1.0, 0.0, 0.0, 1.8],
            [-1.0, 0.0, 0.0, 1.8],
        ]),
        plane_albedo=t([0.55, 0.85, 0.7, 0.4]),
    )


def _distances(scene: Scene, p: torch.Tensor) -> torch.Tensor:
    """Signed distance of p (..., 3) to every primitive -> (..., S + B + P)."""
    d_s = torch.linalg.norm(p[..., None, :] - scene.sphere_center, dim=-1) - scene.sphere_radius
    q = torch.abs(p[..., None, :] - scene.box_center) - scene.box_half
    d_b = torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1) + torch.clamp(
        torch.amax(q, dim=-1), max=0.0
    )
    d_p = p @ scene.plane[:, :3].T + scene.plane[:, 3]
    return torch.cat([d_s, d_b, d_p], dim=-1)


def scene_sdf(scene: Scene, p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """SDF and albedo (of the nearest primitive) at points p (..., 3)."""
    dists = _distances(scene, p)
    albedos = torch.cat([scene.sphere_albedo, scene.box_albedo, scene.plane_albedo])
    return torch.amin(dists, dim=-1), albedos[torch.argmin(dists, dim=-1)]


def _sdf_normal(scene: Scene, p: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    grads = []
    for e in torch.eye(3, dtype=p.dtype, device=p.device) * eps:
        grads.append(
            torch.amin(_distances(scene, p + e), dim=-1) - torch.amin(_distances(scene, p - e), dim=-1)
        )
    n = torch.stack(grads, dim=-1)
    return n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-9)


def render(
    scene: Scene,
    T_wc: torch.Tensor,  # (4, 4) camera-to-world pose
    fx: float, fy: float, cx: float, cy: float,
    height: int,
    width: int,
    num_steps: int = 96,
    max_depth: float = 8.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sphere-trace one frame on T_wc's device. Returns (depth (H, W) meters,
    gray (H, W) in [0, 1]); misses give depth 0 (invalid)."""
    dev = T_wc.device
    v = torch.arange(height, dtype=torch.float32, device=dev)[:, None].expand(height, width)
    u = torch.arange(width, dtype=torch.float32, device=dev)[None, :].expand(height, width)
    dirs_cam = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], dim=-1)
    origin = T_wc[:3, 3]
    dirs = dirs_cam @ T_wc[:3, :3].T  # unnormalised: the ray parameter is z_cam
    dir_len = torch.linalg.norm(dirs, dim=-1)
    t = torch.full((height, width), 0.05, dtype=torch.float32, device=dev)
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
    # textured shading so photometric odometry has gradients everywhere
    tex = 0.75 + 0.25 * torch.sin(9.0 * p[..., 0]) * torch.sin(7.0 * p[..., 1]) * torch.sin(
        11.0 * p[..., 2]
    )
    gray = torch.where(hit, albedo * (0.3 + 0.7 * lambert) * tex, 0.0)
    return depth, gray


def _poses_from_twists(xis: list[np.ndarray]) -> np.ndarray:
    return se3.se3_exp(torch.from_numpy(np.stack(xis).astype(np.float32))).numpy()


def orbit_trajectory(num_frames: int, radius: float = 0.25) -> np.ndarray:
    """Smooth wobbling handheld-style sweep, (num_frames, 4, 4) camera-to-world:
    a few cm / a few degrees of motion between frames."""
    xis = []
    for i in range(num_frames):
        s = i / max(num_frames - 1, 1)
        ang = s * 1.2 - 0.6
        xis.append(np.array([
            radius * np.sin(ang * 2.0), 0.08 * np.sin(s * 5.0), 0.15 * np.sin(ang * 1.5),
            0.1 * np.sin(s * 3.0), 0.4 * np.sin(ang), 0.05 * np.sin(s * 4.0),
        ], np.float32))
    return _poses_from_twists(xis)


def loop_trajectory(num_frames: int, radius: float = 0.35) -> np.ndarray:
    """Closed camera loop (num_frames, 4, 4): every motion term is periodic,
    so the last pose returns towards the first."""
    xis = []
    for i in range(num_frames):
        ang = 2.0 * np.pi * i / num_frames
        xis.append(np.array([
            radius * np.sin(ang), 0.06 * np.sin(2 * ang), 0.18 * (1.0 - np.cos(ang)),
            0.08 * np.sin(2 * ang), 0.45 * np.sin(ang), 0.04 * np.sin(3 * ang),
        ], np.float32))
    return _poses_from_twists(xis)


# The sensor model (numpy only): Kinect-style axial depth noise
# sigma(z) = a + b (z - 0.4)^2 (Khoshelham & Elberink 2012's quadratic fit),
# dropout holes (IR shadows, specular returns) and sensor gray noise, with
# an optional textureless (contrast-collapsed) segment that starves the
# sparse front end of corners. The same draws as the JAX package's, bit for
# bit.
DEPTH_NOISE_A = 0.0012  # m
DEPTH_NOISE_B = 0.0019  # m^-1
DEFAULT_HOLES = 10
GRAY_SIGMA = 0.01


def corrupt_rgbd(
    rng: np.random.Generator,
    gray: np.ndarray,
    depth: np.ndarray,
    holes: int = DEFAULT_HOLES,
    hole_radius: tuple[int, int] = (4, 24),
    gray_sigma: float = GRAY_SIGMA,
    contrast: float = 1.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Apply the sensor model to one clean (gray, depth) pair (host-side;
    corruption is data preparation, not a compute path). `contrast` < 1
    collapses texture around the mean (textureless-wall surrogate)."""
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


def quantize_rgbd(gray, depth, depth_scale: float = 5000.0):
    """Round-trip through the on-disk TUM encoding (uint8 gray, uint16
    depth) so in-memory benchmarks consume bit-identical data to what the
    reference binaries read from PNG."""
    g8 = np.clip(np.asarray(gray) * 255.0, 0, 255).astype(np.uint8)
    d16 = np.clip(np.asarray(depth) * depth_scale, 0, 65535).astype(np.uint16)
    return g8.astype(np.float32) / 255.0, d16.astype(np.float32) / depth_scale


def corrupt_sequence(
    grays: np.ndarray,
    depths: np.ndarray,
    seed: int = 1000,
    textureless: tuple[int, int] | None = None,
    contrast: float = 0.06,
    quantize: bool = True,
    **kw,
) -> tuple[np.ndarray, np.ndarray]:
    """Corrupt a rendered sequence deterministically (per-frame seeded
    generators, so disk writer and in-memory bench agree exactly).
    `textureless=(k0, k1)` collapses contrast on that frame range; extra
    kwargs pass through to `corrupt_rgbd`."""
    gs, ds = [], []
    for i in range(len(grays)):
        rng = np.random.default_rng(seed + i)
        c = contrast if textureless and textureless[0] <= i < textureless[1] else 1.0
        g, d = corrupt_rgbd(rng, grays[i], depths[i], contrast=c, **kw)
        if quantize:
            g, d = quantize_rgbd(g, d)
        gs.append(g)
        ds.append(d)
    return np.stack(gs), np.stack(ds)
