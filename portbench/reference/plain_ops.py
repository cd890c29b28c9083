"""Plain PyTorch operations of the dense fusion path, frozen.

Copies of the port's plain (CPU-path) versions, which hold the kernels'
arithmetic in the kernels' operation order: the image filters
(`ops/image.py`), the pinhole pyramid (`geometry/camera.py`), the frame
pyramid and the Gauss-Newton tracker (`odometry/dense.py`,
`ops/dense_odometry.py`: `normal_equations_reference`, `solve6_reference`,
`solve_and_update`), the touched block keys (`ops/tsdf.py`), the TSDF
update of pool rows (`ops/tsdf_slots.integrate_slots_reference`),
marching cubes (`ops/marching_cubes.extract_triangles_reference`) and the
vertex dedup (`ops/mesh_dedup.py`). They run on any device and launch no
kernel of the program.

`rnd` is the precision of the control: the identity for the reference
itself, a round trip through bfloat16 for the control, applied where the
data is stored (images, term data, points, pool rows); sums stay float32.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..inputs.synthetic import se3_exp
from .mc_tables import CORNER_POS, EDGE_CORNERS, MAX_TRIS_PER_VOXEL, TRI_COUNTS, TRI_TABLE


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def _recip(x: float) -> float:
    return float(np.float32(1.0) / np.float32(x))


# --- camera ------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Camera:
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    def next_level(self) -> "Camera":
        return Camera(self.fx * 0.5, self.fy * 0.5, (self.cx + 0.5) * 0.5 - 0.5, (self.cy + 0.5) * 0.5 - 0.5,
                      self.width // 2, self.height // 2)

    def pyramid(self, levels: int) -> tuple["Camera", ...]:
        cams = [self]
        for _ in range(levels - 1):
            cams.append(cams[-1].next_level())
        return tuple(cams)

    def backproject_grid(self, depth: torch.Tensor) -> torch.Tensor:
        h, w = depth.shape
        v = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None].expand(h, w)
        u = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :].expand(h, w)
        x = (u - self.cx) / self.fx * depth
        y = (v - self.cy) / self.fy * depth
        return torch.stack([x, y, depth], dim=-1)


# --- SE(3) -------------------------------------------------------------------


def make_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:].expand(R.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def inverse_T(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make_T(Rt, -(Rt @ T[..., :3, 3, None])[..., 0])


# --- image filters -----------------------------------------------------------


def _conv2d_same(img: torch.Tensor, kernel) -> torch.Tensor:
    k_np = np.asarray(kernel)
    kh, kw = k_np.shape
    ph, pw = kh // 2, kw // 2
    h, w = img.shape
    padded = F.pad(img[None, None], (pw, pw, ph, ph), mode="replicate")[0, 0]
    out = torch.zeros_like(img)
    for iy in range(kh):
        for ix in range(kw):
            c = float(k_np[iy, ix])
            if c == 0.0:
                continue
            out = out + c * padded[iy : iy + h, ix : ix + w]
    return out


_BINOMIAL5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
_SOBEL_X = np.array([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]])


def gaussian_blur(img: torch.Tensor) -> torch.Tensor:
    k = _BINOMIAL5
    return _conv2d_same(_conv2d_same(img, k[None, :]), k[:, None])


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    return gaussian_blur(img)[::2, ::2]


def sobel(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return _conv2d_same(img, _SOBEL_X), _conv2d_same(img, _SOBEL_X.T)


def box_sum3(img: torch.Tensor) -> torch.Tensor:
    return _conv2d_same(img, np.ones((3, 3)))


def clip_depth(depth: torch.Tensor, near: float, far: float) -> torch.Tensor:
    ok = torch.isfinite(depth) & (depth >= near) & (depth <= far)
    return torch.where(ok, depth, 0.0)


def bilateral_filter(depth: torch.Tensor, radius: int = 2, sigma_space: float = 2.0,
                     sigma_value: float = 0.03) -> torch.Tensor:
    h, w = depth.shape
    r = radius
    padded = F.pad(depth, (r, r, r, r))
    acc = torch.zeros_like(depth)
    wacc = torch.zeros_like(depth)
    valid_c = depth > 0
    inv2v = 1.0 / (2 * sigma_value**2)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            shifted = padded[r + dy : r + dy + h, r + dx : r + dx + w]
            ok = (shifted > 0) & valid_c
            ws = math.exp(-(dx * dx + dy * dy) / (2 * sigma_space**2))
            wv = torch.exp(-((shifted - depth) ** 2) * inv2v)
            w_ = torch.where(ok, ws * wv, 0.0)
            acc = acc + w_ * shifted
            wacc = wacc + w_
    out = torch.where(wacc > 1e-8, acc / torch.clamp(wacc, min=1e-8), depth)
    return torch.where(valid_c, out, 0.0)


def bilinear_sample(img: torch.Tensor, uv: torch.Tensor, *, valid_zero: bool = False):
    h, w = img.shape
    u = uv[..., 0]
    v = uv[..., 1]
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = u - u0
    fv = v - v0
    u0i = u0.to(torch.int32)
    v0i = v0.to(torch.int32)
    inb = (u0i >= 0) & (u0i < w - 1) & (v0i >= 0) & (v0i < h - 1)
    u0c = torch.clamp(u0i, 0, w - 2).long()
    v0c = torch.clamp(v0i, 0, h - 2).long()
    p00 = img[v0c, u0c]
    p01 = img[v0c, u0c + 1]
    p10 = img[v0c + 1, u0c]
    p11 = img[v0c + 1, u0c + 1]
    val = p00 * (1 - fu) * (1 - fv) + p01 * fu * (1 - fv) + p10 * (1 - fu) * fv + p11 * fu * fv
    if valid_zero:
        inb = inb & (p00 > 0) & (p01 > 0) & (p10 > 0) & (p11 > 0)
    return val, inb


# --- dense tracking ----------------------------------------------------------

MIN_DEPTH = 0.5
MAX_DEPTH = 4.0
SOBEL_SCALE = 1.0 / 8.0
LAMBDA_HYBRID_DEPTH = 0.5
DEPTH_DIFF_MAX = 0.05
DAMPING = 1e-6


def preprocess_frame(gray, depth, camera: Camera, levels: int, rnd=exact):
    """(grays, depths, xyzs) per level, finest first."""
    g = gaussian_blur(gray.to(torch.float32))
    d = clip_depth(depth.to(torch.float32), MIN_DEPTH, MAX_DEPTH)
    vb = gaussian_blur((d > 0).to(torch.float32))
    d = torch.where(vb > 0.9999, gaussian_blur(d), 0.0)
    grays, depths = [rnd(g)], [rnd(d)]
    for _ in range(levels - 1):
        grays.append(rnd(pyr_down(grays[-1])))
        h, w = depths[-1].shape
        q = depths[-1][: h - h % 2, : w - w % 2].reshape(h // 2, 2, w // 2, 2)
        valid = (q > 0).to(q.dtype)
        s = torch.sum(q * valid, dim=(1, 3))
        c = torch.sum(valid, dim=(1, 3))
        depths.append(rnd(torch.where(c > 0, s / torch.clamp(c, min=1.0), 0.0)))
    xyzs = [rnd(c.backproject_grid(dl)) for c, dl in zip(camera.pyramid(levels), depths)]
    return grays, depths, xyzs


def term_data(gray: torch.Tensor, depth: torch.Tensor, rnd=exact) -> torch.Tensor:
    """(H, W, 8): gray, dx, dy, depth, zdx, zdy, 0, 0."""
    dx, dy = sobel(gray)
    zdx, zdy = sobel(depth)
    interior = box_sum3((depth > 0).to(gray.dtype)) > 8.5
    zdx = torch.where(interior, zdx, 0.0)
    zdy = torch.where(interior, zdy, 0.0)
    pad = torch.zeros_like(gray)
    s = SOBEL_SCALE
    return rnd(torch.stack([gray, dx * s, dy * s, depth, zdx * s, zdy * s, pad, pad], dim=-1))


def _stream_weights(lambda_depth: float) -> tuple[float, float]:
    lam = np.float32(lambda_depth)
    w_i = np.sqrt(np.maximum(np.float32(1.0) - lam, np.float32(0.0)))
    w_z = np.sqrt(np.maximum(lam, np.float32(0.0)))
    return float(w_i * w_i), float(w_z * w_z)


def _twist(p, g) -> torch.Tensor:
    px, py, pz = p
    g0, g1, g2 = g
    return torch.stack([g0, g1, g2, py * g2 - pz * g1, pz * g0 - px * g2, px * g1 - py * g0], dim=-1)


def normal_equations(T, src_xyz, src_gray, src_valid, tex, fx, fy, cx, cy):
    """One linearisation of the hybrid term: (JTJ, JTr, cost, inliers)."""
    x, y, zs = src_xyz.unbind(-1)
    px = T[0, 0] * x + T[0, 1] * y + T[0, 2] * zs + T[0, 3]
    py = T[1, 0] * x + T[1, 1] * y + T[1, 2] * zs + T[1, 3]
    z = T[2, 0] * x + T[2, 1] * y + T[2, 2] * zs + T[2, 3]
    zsafe = torch.where(z > 1e-6, z, 1.0)
    uv = torch.stack([px / zsafe * fx + cx, py / zsafe * fy + cy], dim=-1)
    g, ok_g = bilinear_sample(tex[..., 0], uv)
    gx, _ = bilinear_sample(tex[..., 1], uv)
    gy, _ = bilinear_sample(tex[..., 2], uv)
    zt, ok_z = bilinear_sample(tex[..., 3], uv, valid_zero=True)
    ztx, _ = bilinear_sample(tex[..., 4], uv)
    zty, _ = bilinear_sample(tex[..., 5], uv)
    r_i = g - src_gray
    r_z = zt - z
    valid = src_valid & ok_g & ok_z & (z > 1e-6) & (torch.abs(r_z) < DEPTH_DIFF_MAX)
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
    w_i, w_z = _stream_weights(LAMBDA_HYBRID_DEPTH)
    J = torch.stack([J_i, J_z], dim=1)
    r = torch.stack([r_i, r_z], dim=1)
    wgt = torch.stack([vf * w_i, vf * w_z], dim=1)
    JTJ = torch.einsum("nki,nk,nkj->ij", J, wgt, J)
    JTr = torch.einsum("nki,nk,nk->i", J, wgt, r)
    cost = torch.einsum("nk,nk->", wgt, r * r)
    return JTJ, JTr, cost, torch.sum(vf)


def solve6(A: torch.Tensor, b: torch.Tensor):
    """LU with partial pivoting in float32; (x, no pivot exactly zero)."""
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


def gn_step(T, src_xyz, src_gray, src_valid, tex, cam: Camera):
    JTJ, JTr, cost, inl = normal_equations(T, src_xyz, src_gray, src_valid, tex, cam.fx, cam.fy, cam.cx, cam.cy)
    A = JTJ + DAMPING * torch.eye(6, dtype=JTJ.dtype, device=JTJ.device)
    xi, nonsingular = solve6(A, -JTr)
    ok = torch.isfinite(xi).all() & (inl > 6) & nonsingular
    return torch.where(ok, se3_exp(xi) @ T, T)


def dense_tracking(source, target, camera: Camera, init_T: torch.Tensor, iters: tuple[int, ...], rnd=exact):
    """T_ts: coarse-to-fine Gauss-Newton of source onto target, iters[0] at
    the coarsest level."""
    levels = len(source[0])
    T = init_T.clone()
    cams = camera.pyramid(levels)
    for li in reversed(range(levels)):
        tex = term_data(target[0][li], target[1][li], rnd)
        xyz = source[2][li].reshape(-1, 3)
        gray = source[0][li].reshape(-1)
        valid = xyz[:, 2] > 0
        for _ in range(iters[levels - 1 - li]):
            T = gn_step(T, xyz, gray, valid, tex, cams[li])
    return T


# --- TSDF --------------------------------------------------------------------

CUBE = 8
N_VOX = CUBE**3
EMPTY_SDF = 999.0
INVALID_KEY = 1 << 30
OFFSET_FRACTIONS = (-1.0, -0.5, 0.0, 0.5, 1.0)


def fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def transform_fma(T, x, y, z):
    return tuple(fma(T[r, 2], z, fma(T[r, 1], y, T[r, 0] * x)) + T[r, 3] for r in range(3))


def unique_padded(keys: torch.Tensor, size: int) -> torch.Tensor:
    s, _ = torch.sort(keys)
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    rank = torch.cumsum(first, dim=0) - 1
    idx = torch.where(first & (rank < size), rank, size)
    out = torch.full((size + 1,), INVALID_KEY, dtype=keys.dtype, device=keys.device)
    out.scatter_(0, idx, s)
    return out[:size]


def touched_block_keys(depth, T_wc, fx, fy, cx, cy, voxel_size, truncation, max_blocks, stride):
    """Sorted unique packed keys of the blocks in the truncation band,
    (max_blocks,) INVALID_KEY-padded; pixels subsampled by `stride`."""
    fx, fy, cx, cy = (float(np.float32(c) * np.float32(_recip(stride))) for c in (fx, fy, cx, cy))
    d = depth[::stride, ::stride]
    h, w = d.shape
    v = torch.arange(h, dtype=torch.float32, device=d.device)[:, None].expand(h, w)
    u = torch.arange(w, dtype=torch.float32, device=d.device)[None, :].expand(h, w)
    dirs = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], dim=-1)
    R, t = T_wc[:3, :3], T_wc[:3, 3]
    inv_edge = _recip(voxel_size * CUBE)
    coords = []
    for off in (torch.tensor(OFFSET_FRACTIONS, dtype=torch.float32) * truncation).tolist():
        pts_w = (dirs * (d + off)[..., None]) @ R.T + t
        coords.append(torch.floor(pts_w * inv_edge).to(torch.int32).reshape(-1, 3))
    coords = torch.cat(coords)
    valid = (d > 0).reshape(-1).repeat(len(OFFSET_FRACTIONS))
    c = torch.clamp(coords + 512, 0, 1023)
    keys = torch.where(valid, (c[:, 0] << 20) | (c[:, 1] << 10) | c[:, 2], INVALID_KEY)
    ko = keys.reshape(len(OFFSET_FRACTIONS), h, w)
    dup = torch.zeros_like(ko, dtype=torch.bool)
    dup[1:] = ko[1:] == ko[:-1]
    dup[:, :, 1:] |= ko[:, :, 1:] == ko[:, :, :-1]
    return unique_padded(torch.where(dup.reshape(-1), INVALID_KEY, keys), max_blocks)


def pack_keys(coords: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(coords.to(torch.int32) + 512, 0, 1023)
    return (c[..., 0] << 20) | (c[..., 1] << 10) | c[..., 2]


def make_pool(capacity: int, device) -> torch.Tensor:
    vox = torch.zeros((capacity + 1, 5, N_VOX), dtype=torch.float32, device=device)
    vox[:, 0, :] = EMPTY_SDF
    return vox


def integrate_rows(vox, keys, slots, img, T_cw, fx, fy, cx, cy, voxel_size, truncation, max_weight):
    """One frame's TSDF update of pool rows `slots` (K,) of blocks `keys`, in
    place; img (4, H, W) [depth, r, g, b] or (2, H, W) [depth, gray].
    Returns (voxels updated, of them with weight 0 before)."""
    n = CUBE
    n_img, h, w = img.shape
    lin = torch.arange(N_VOX, device=vox.device)
    ii, jj, kk = lin // (n * n), (lin // n) % n, lin % n
    k = keys[:, None]
    bx = ((k >> 20) & 1023) - 512
    by = ((k >> 10) & 1023) - 512
    bz = (k & 1023) - 512
    xw = ((bx * n + ii).to(torch.float32) + 0.5) * voxel_size
    yw = ((by * n + jj).to(torch.float32) + 0.5) * voxel_size
    zw = ((bz * n + kk).to(torch.float32) + 0.5) * voxel_size
    xc, yc, zc = transform_fma(T_cw, xw, yw, zw)
    zsafe = torch.where(zc > 1e-6, zc, 1.0)
    ui = torch.round(xc / zsafe * fx + cx).to(torch.int32)
    vi = torch.round(yc / zsafe * fy + cy).to(torch.int32)
    inb = (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h) & (zc > 1e-6)
    pix = torch.clamp(vi, 0, h - 1).long() * w + torch.clamp(ui, 0, w - 1).long()
    d = img[0].reshape(-1)[pix]
    cols = [img[c].reshape(-1)[pix] for c in range(1, n_img)]
    if n_img == 2:
        cols = cols * 3
    sdf_m = d - zc
    in_pool = (slots >= 0) & (slots < vox.shape[0])
    upd = inb & (d > 0) & (sdf_m > -truncation) & (k != INVALID_KEY) & in_pool[:, None]
    rows = torch.where(in_pool, slots, vox.shape[0] - 1).long()
    old = vox[rows]
    w_old = old[:, 1]
    denom = torch.clamp(w_old + 1.0, min=1.0)
    tsdf_new = torch.clamp(sdf_m / truncation, -1.0, 1.0)
    has = w_old > 0
    new = torch.empty_like(old)
    new[:, 0] = torch.where(upd, (torch.where(has, old[:, 0], 0.0) * w_old + tsdf_new) / denom, old[:, 0])
    new[:, 1] = torch.where(upd, torch.clamp(w_old + 1.0, max=max_weight), w_old)
    for c, c_px in enumerate(cols, start=2):
        c_safe = torch.where(has, old[:, c], 0.0)
        new[:, c] = torch.where(upd, (c_safe * w_old + c_px) / denom, old[:, c])
    vox[rows] = new
    return int(upd.sum()), int((upd & ~has).sum())


# --- marching cubes ------------------------------------------------------------

NEIGHBOR_OFFSETS = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [1, 0, 1], [0, 1, 1], [1, 1, 1]], np.int32)
MC_CHUNK = 128
FILLS = (EMPTY_SDF, 0.0, 0.0)


def neighbor_slots(block_coords: torch.Tensor) -> torch.Tensor:
    """(N, 3) coords of the blocks at rows 0..N-1 -> (N, 7) rows of their
    NEIGHBOR_OFFSETS neighbours, -1 where absent."""
    coords = block_coords.to(torch.int32)
    n = coords.shape[0]
    if n == 0:
        return torch.zeros((0, 7), dtype=torch.int32, device=coords.device)
    keys, order = torch.sort(pack_keys(coords))
    nbr = coords[:, None, :] + torch.from_numpy(NEIGHBOR_OFFSETS).to(coords.device)
    in_range = ((nbr >= -512) & (nbr <= 511)).all(-1)
    nkeys = pack_keys(nbr)
    pos = torch.clamp(torch.searchsorted(keys, nkeys), max=n - 1)
    found = in_range & (keys[pos] == nkeys)
    return torch.where(found, order[pos], -1).to(torch.int32)


def _gather(field, slots, fill):
    safe = torch.clamp(slots, 0, field.shape[0] - 1).long()
    vals = field[safe]
    present = (slots >= 0).reshape(slots.shape + (1,) * (vals.dim() - 2))
    return torch.where(present, vals, fill)


def _halo_grid(values, nbr_values):
    n = CUBE
    g = values.new_zeros((values.shape[0], n + 1, n + 1, n + 1) + values.shape[4:])
    g[:, :n, :n, :n] = values
    nx, ny, nz, nxy, nxz, nyz, nxyz = nbr_values.unbind(1)
    g[:, n, :n, :n] = nx[:, 0]
    g[:, :n, n, :n] = ny[:, :, 0]
    g[:, :n, :n, n] = nz[:, :, :, 0]
    g[:, n, n, :n] = nxy[:, 0, 0]
    g[:, n, :n, n] = nxz[:, 0, :, 0]
    g[:, :n, n, n] = nyz[:, :, 0, 0]
    g[:, n, n, n] = nxyz[:, 0, 0, 0]
    return g


def _corners(g, dim):
    n = CUBE
    return torch.stack([g[:, dx : dx + n, dy : dy + n, dz : dz + n] for dx, dy, dz in CORNER_POS.tolist()], dim)


def block_triangles(sdf, weight, color, nbr_sdf, nbr_weight, nbr_color, block_coords, voxel_size, iso=0.0):
    """(verts (B, 512, MAX_T, 3, 3), colours, valid (B, 512, MAX_T))."""
    b = sdf.shape[0]
    n = CUBE
    dev = sdf.device
    corners = _corners(_halo_grid(sdf, nbr_sdf), -1)
    cweights = _corners(_halo_grid(weight, nbr_weight), -1)
    ccolors = _corners(_halo_grid(color, nbr_color), -2)
    voxel_ok = (cweights > 0).all(-1) & (torch.abs(corners) < 1.5).all(-1)
    bits = torch.arange(8, device=dev, dtype=torch.int64)
    config = ((corners < iso).to(torch.int64) << bits).sum(-1)
    ca = torch.from_numpy(EDGE_CORNERS[:, 0]).long().to(dev)
    cb = torch.from_numpy(EDGE_CORNERS[:, 1]).long().to(dev)
    va = corners[..., ca]
    vb = corners[..., cb]
    denom = va - vb
    cut = torch.abs(denom) > 1e-9
    tpar = torch.clamp(torch.where(cut, (va - iso) / torch.where(cut, denom, 1.0), 0.5), 0.0, 1.0)
    corner_pos = torch.from_numpy(CORNER_POS).to(dev, torch.float32)
    pa, pb = corner_pos[ca], corner_pos[cb]
    edge_local = pa + tpar[..., None] * (pb - pa)
    ar = torch.arange(n, device=dev, dtype=torch.float32)
    ijk = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), -1)
    base = block_coords.to(torch.float32)[:, None, None, None, :] * n + ijk
    edge_world = (base[..., None, :] + edge_local + 0.5) * voxel_size
    cola, colb = ccolors[..., ca, :], ccolors[..., cb, :]
    edge_color = cola + tpar[..., None] * (colb - cola)
    tri = torch.from_numpy(TRI_TABLE).long().to(dev)[config]
    counts = torch.from_numpy(TRI_COUNTS).long().to(dev)[config]
    valid = (torch.arange(MAX_TRIS_PER_VOXEL, device=dev) < counts[..., None]) & voxel_ok[..., None]
    idx = torch.clamp(tri, min=0).reshape(b, n, n, n, MAX_TRIS_PER_VOXEL * 3, 1).expand(-1, -1, -1, -1, -1, 3)
    shape = (b, n**3, MAX_TRIS_PER_VOXEL, 3, 3)
    tv = torch.gather(edge_world, -2, idx).reshape(shape)
    tc = torch.gather(edge_color, -2, idx).reshape(shape)
    return tv, tc, valid.reshape(shape[:3])


def pool_fields(vox):
    n = CUBE
    r = vox.shape[0]
    return (vox[:, 0].reshape(r, n, n, n), vox[:, 1].reshape(r, n, n, n),
            torch.movedim(vox[:, 2:5], 1, -1).reshape(r, n, n, n, 3))


def extract_triangles(vox, slots, nbr, block_coords, voxel_size, iso=0.0, chunk=MC_CHUNK):
    """Triangles of the blocks at rows `slots`, in (block, voxel, triangle)
    order: (verts (T, 3, 3), colours (T, 3, 3), triangles per block (B,))."""
    rows = vox.shape[0]
    fields = pool_fields(vox)

    def present(s):
        return torch.where((s >= 0) & (s < rows), s, -1)

    slots, nbr = present(slots), present(nbr)
    verts, colors, per_block = [vox.new_zeros((0, 3, 3))], [vox.new_zeros((0, 3, 3))], []
    for s in range(0, slots.shape[0], chunk):
        own = [_gather(f, slots[s : s + chunk, None], fill)[:, 0] for f, fill in zip(fields, FILLS)]
        nb = [_gather(f, nbr[s : s + chunk], fill) for f, fill in zip(fields, FILLS)]
        tv, tc, valid = block_triangles(*own, *nb, block_coords[s : s + chunk], voxel_size, iso)
        v = valid.reshape(-1)
        verts.append(tv.reshape(-1, 3, 3)[v])
        colors.append(tc.reshape(-1, 3, 3)[v])
        per_block.append(valid.sum((1, 2)))
    counts = torch.cat(per_block) if per_block else torch.zeros(0, dtype=torch.int64, device=vox.device)
    return torch.cat(verts), torch.cat(colors), counts


def dedup_triangle_soup(tri_verts, tri_colors, quantum: float = 1e-5):
    """(vertices (V, 3), faces (F, 3), colours (V, 3)) of a triangle soup,
    identical vertices (quantised to `quantum`) merged in first-seen order."""
    flat = tri_verts.reshape(-1, 3)
    n = flat.shape[0]
    dev = flat.device
    keys = torch.round(flat / torch.full((), quantum, dtype=flat.dtype, device=dev)).to(torch.int64)
    order = torch.arange(n, device=dev)
    for d in (2, 1, 0):
        order = order[torch.sort(keys[order, d], stable=True)[1]]
    sorted_keys = keys[order]
    start = torch.ones(n, dtype=torch.bool, device=dev)
    start[1:] = (sorted_keys[1:] != sorted_keys[:-1]).any(1)
    inv = torch.empty(n, dtype=torch.int64, device=dev)
    inv[order] = torch.cumsum(start, 0) - 1
    first = order[start]
    faces = inv.reshape(-1, 3)
    ok = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    return flat[first], faces[ok], tri_colors.reshape(-1, 3)[first]
