"""Marching cubes over TSDF voxel blocks.

Port of `onepiece_tpu/ops/marching_cubes.py`: `gather_neighbors`,
`extract_block_triangles` (as `extract_block_triangles_reference`) and
`compact_triangles` (as `compact_triangles_reference`), with the JAX
package's shapes, so the tests hold them against it one by one. Each voxel
of a block reads the 8 corners of its cube; the +1 halo of corners outside
the block comes from its 7 neighbour blocks (NEIGHBOR_OFFSETS), absent ones
read sdf EMPTY_SDF and weight 0. A voxel meshes when all 8 corner weights
are > 0 and all |sdf| < 1.5; its corner signs pick one of the 256 cases of
the triangle table (`mc_tables.py`), indexed directly (the JAX package's
one-hot `_SEL` / `_VALID` matmuls exist only because a dynamic table gather
compiled slowly on the TPU).

`extract_triangles` meshes blocks straight from the port's channels-first
pool `(B + 1, 5, 512)` [sdf, weight, r, g, b]: the CUDA kernel
(`csrc/marching_cubes.cu`) on CUDA tensors, the plain version
(`extract_triangles_reference`, chunks of blocks, as the JAX package's
`lax.map` over chunks) on CPU tensors. Triangles come out in (block, voxel
i-j-k row-major, triangle) order, the order of the JAX package's
`jnp.nonzero` compaction, and none is dropped: the output is sized from the
count (the JAX package caps each chunk at `chunk * cap_per_block`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..utils import tracing
from .mc_tables import CORNER_POS, EDGE_CORNERS, MAX_TRIS_PER_VOXEL, TRI_COUNTS, TRI_TABLE
from .tsdf import CUBE_SIZE, EMPTY_SDF

# The 7 neighbour offsets needed for the +1 halo, in a fixed order.
NEIGHBOR_OFFSETS = np.array(
    [[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [1, 0, 1], [0, 1, 1], [1, 1, 1]],
    np.int32,
)
DEFAULT_CHUNK = 128  # blocks per step of the plain version
FILLS = (EMPTY_SDF, 0.0, 0.0)  # sdf, weight, colour of an absent block


def gather_neighbors(pool_field: torch.Tensor, neighbor_slots: torch.Tensor, fill: float) -> torch.Tensor:
    """pool_field (P, 8, 8, 8[, ...]), neighbor_slots (B, K) int (-1 = absent)
    -> (B, K, 8, 8, 8[, ...]) with `fill` where absent (slots >= P read row
    P - 1, as the JAX package's clipped gather does)."""
    safe = torch.clamp(neighbor_slots, 0, pool_field.shape[0] - 1).long()
    vals = pool_field[safe]
    present = (neighbor_slots >= 0).reshape(neighbor_slots.shape + (1,) * (vals.dim() - 2))
    return torch.where(present, vals, fill)


def _halo_grid(values: torch.Tensor, neighbor_values: torch.Tensor) -> torch.Tensor:
    """(B, 9, 9, 9[, ...]) corner grid from the block's own values (B, 8, 8,
    8[, ...]) and its 7 neighbours' (B, 7, 8, 8, 8[, ...], NEIGHBOR_OFFSETS order)."""
    n = CUBE_SIZE
    g = values.new_zeros((values.shape[0], n + 1, n + 1, n + 1) + values.shape[4:])
    g[:, :n, :n, :n] = values
    nx, ny, nz, nxy, nxz, nyz, nxyz = neighbor_values.unbind(1)
    g[:, n, :n, :n] = nx[:, 0]
    g[:, :n, n, :n] = ny[:, :, 0]
    g[:, :n, :n, n] = nz[:, :, :, 0]
    g[:, n, n, :n] = nxy[:, 0, 0]
    g[:, n, :n, n] = nxz[:, 0, :, 0]
    g[:, :n, n, n] = nyz[:, :, 0, 0]
    g[:, n, n, n] = nxyz[:, 0, 0, 0]
    return g


def _corners(g: torch.Tensor, dim: int) -> torch.Tensor:
    """The 8 cube corners of every voxel, stacked at `dim`: (B, 8, 8, 8, [...])."""
    n = CUBE_SIZE
    return torch.stack([g[:, dx : dx + n, dy : dy + n, dz : dz + n] for dx, dy, dz in CORNER_POS.tolist()], dim)


def extract_block_triangles_reference(
    sdf: torch.Tensor,  # (B, 8, 8, 8) normalised tsdf
    weight: torch.Tensor,  # (B, 8, 8, 8)
    color: torch.Tensor,  # (B, 8, 8, 8, 3)
    nbr_sdf: torch.Tensor,  # (B, 7, 8, 8, 8)
    nbr_weight: torch.Tensor,  # (B, 7, 8, 8, 8)
    nbr_color: torch.Tensor,  # (B, 7, 8, 8, 8, 3)
    block_coords: torch.Tensor,  # (B, 3) int
    voxel_size: float,
    iso: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the JAX package's `extract_block_triangles`:
    (tri_verts (B, 512, MAX_T, 3, 3) world coords, tri_colors (B, 512, MAX_T,
    3, 3), tri_valid (B, 512, MAX_T) bool). The kernel repeats these
    operations, in this order, per voxel."""
    b = sdf.shape[0]
    n = CUBE_SIZE
    dev = sdf.device
    corners = _corners(_halo_grid(sdf, nbr_sdf), -1)  # (B, n, n, n, 8)
    cweights = _corners(_halo_grid(weight, nbr_weight), -1)
    ccolors = _corners(_halo_grid(color, nbr_color), -2)  # (B, n, n, n, 8, 3)

    voxel_ok = (cweights > 0).all(-1) & (torch.abs(corners) < 1.5).all(-1)
    bits = torch.arange(8, device=dev, dtype=torch.int64)
    config = ((corners < iso).to(torch.int64) << bits).sum(-1)  # (B, n, n, n)

    # 12 edge-interpolated vertices per voxel
    ca = torch.from_numpy(EDGE_CORNERS[:, 0]).long().to(dev)
    cb = torch.from_numpy(EDGE_CORNERS[:, 1]).long().to(dev)
    va = corners[..., ca]  # (B, n, n, n, 12)
    vb = corners[..., cb]
    denom = va - vb
    cut = torch.abs(denom) > 1e-9
    tpar = torch.clamp(torch.where(cut, (va - iso) / torch.where(cut, denom, 1.0), 0.5), 0.0, 1.0)
    corner_pos = torch.from_numpy(CORNER_POS).to(dev, torch.float32)
    pa, pb = corner_pos[ca], corner_pos[cb]  # (12, 3) local corner offsets
    edge_local = pa + tpar[..., None] * (pb - pa)  # (B, n, n, n, 12, 3)
    # world position: (block * 8 + voxel index + local + 0.5) * voxel_size
    ar = torch.arange(n, device=dev, dtype=torch.float32)
    ijk = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), -1)  # (n, n, n, 3)
    base = block_coords.to(torch.float32)[:, None, None, None, :] * n + ijk
    edge_world = (base[..., None, :] + edge_local + 0.5) * voxel_size
    cola, colb = ccolors[..., ca, :], ccolors[..., cb, :]
    edge_color = cola + tpar[..., None] * (colb - cola)

    # triangle emission: the table row of each voxel's case, read directly
    tri = torch.from_numpy(TRI_TABLE).long().to(dev)[config]  # (B, n, n, n, MAX_T, 3), -1 padding
    counts = torch.from_numpy(TRI_COUNTS).long().to(dev)[config]
    valid = (torch.arange(MAX_TRIS_PER_VOXEL, device=dev) < counts[..., None]) & voxel_ok[..., None]
    idx = torch.clamp(tri, min=0).reshape(b, n, n, n, MAX_TRIS_PER_VOXEL * 3, 1).expand(-1, -1, -1, -1, -1, 3)
    shape = (b, n**3, MAX_TRIS_PER_VOXEL, 3, 3)
    tv = torch.gather(edge_world, -2, idx).reshape(shape)
    tc = torch.gather(edge_color, -2, idx).reshape(shape)
    return tv, tc, valid.reshape(shape[:3])


def compact_triangles_reference(
    tv: torch.Tensor, tc: torch.Tensor, valid: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The valid triangles, in the flat order of `valid` (as `jnp.nonzero`
    gives them): (verts (T, 3, 3), colors (T, 3, 3)). Nothing is capped."""
    v = valid.reshape(-1)
    return tv.reshape(-1, 3, 3)[v], tc.reshape(-1, 3, 3)[v]


def _pool_fields(vox: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Views of every pool row (the trash row too) in the JAX layout:
    sdf, weight (R, 8, 8, 8), colour (R, 8, 8, 8, 3). No copy."""
    n = CUBE_SIZE
    r = vox.shape[0]
    return (vox[:, 0].reshape(r, n, n, n), vox[:, 1].reshape(r, n, n, n),
            torch.movedim(vox[:, 2:5], 1, -1).reshape(r, n, n, n, 3))


def extract_triangles_reference(
    vox: torch.Tensor,  # (R, 5, 512) pool
    slots: torch.Tensor,  # (B,) int pool rows of the blocks to mesh
    nbr_slots: torch.Tensor,  # (B, 7) int pool rows of their neighbours, -1 = absent
    block_coords: torch.Tensor,  # (B, 3) int
    voxel_size: float,
    iso: float = 0.0,
    chunk: int = DEFAULT_CHUNK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `extract_triangles`, `chunk` blocks at a time (the
    intermediates stay bounded). Slots outside [0, R) are absent blocks."""
    rows = vox.shape[0]
    fields = _pool_fields(vox)

    def present(s):
        return torch.where((s >= 0) & (s < rows), s, -1)

    slots, nbr_slots = present(slots), present(nbr_slots)
    verts, colors = [vox.new_zeros((0, 3, 3))], [vox.new_zeros((0, 3, 3))]
    for s in range(0, slots.shape[0], chunk):
        own = [gather_neighbors(f, slots[s : s + chunk, None], fill)[:, 0] for f, fill in zip(fields, FILLS)]
        nbr = [gather_neighbors(f, nbr_slots[s : s + chunk], fill) for f, fill in zip(fields, FILLS)]
        tv, tc, valid = extract_block_triangles_reference(*own, *nbr, block_coords[s : s + chunk], voxel_size, iso)
        v, c = compact_triangles_reference(tv, tc, valid)
        verts.append(v)
        colors.append(c)
    return torch.cat(verts), torch.cat(colors)


# the kernel's constant tables, as the C entry `mc_set_tables` takes them
_TRI_I8 = np.ascontiguousarray(TRI_TABLE, np.int8)  # (256, MAX_T, 3), -1 padding
_COUNTS_U8 = np.ascontiguousarray(TRI_COUNTS, np.uint8)  # (256,)
_EDGES_I8 = np.ascontiguousarray(EDGE_CORNERS, np.int8)  # (12, 2)
_tables_on: set[int] = set()  # CUDA devices whose constant memory holds them


def _upload_tables(lib, dev: torch.device) -> None:
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index in _tables_on:
        return
    with torch.cuda.device(index):
        err = lib.mc_set_tables(_TRI_I8.ctypes.data, _COUNTS_U8.ctypes.data, _EDGES_I8.ctypes.data)
    _build.check(err, _build.MARCHING_CUBES)
    _tables_on.add(index)


def _extract_triangles_cuda(vox, slots, nbr_slots, block_coords, voxel_size, iso):
    dev = vox.device
    req = _build.require
    req(vox, "vox", torch.float32, (None, 5, CUBE_SIZE**3), dev)
    req(slots, "slots", torch.int32, (None,), dev)
    b = slots.shape[0]
    req(nbr_slots, "nbr_slots", torch.int32, (b, 7), dev)
    req(block_coords, "block_coords", torch.int32, (b, 3), dev)
    if vox.data_ptr() % 16:
        raise ValueError("vox: the kernel copies pool rows 16 bytes at a time; its storage is not 16-byte aligned")
    if b == 0:  # nothing to mesh: no launch
        return vox.new_zeros((0, 3, 3)), vox.new_zeros((0, 3, 3))
    lib = _build.library()
    _upload_tables(lib, dev)
    stream = _build.stream_handle(vox)
    counts = torch.empty(b, dtype=torch.int32, device=dev)
    listed = torch.zeros(b + 1, dtype=torch.int32, device=dev)  # the blocks with a triangle, then their number
    err = lib.mc_count(vox.data_ptr(), slots.data_ptr(), nbr_slots.data_ptr(), b, vox.shape[0], iso,
                       counts.data_ptr(), listed.data_ptr(), stream)
    _build.check(err, _build.MARCHING_CUBES)
    ends = torch.cumsum(counts, 0, dtype=torch.int32)  # block b writes rows [ends[b-1], ends[b])
    with tracing.sync("mc_size"):
        total, n_listed = torch.stack([ends[-1], listed[b]]).tolist()  # the one host read: the output's size
    verts = torch.empty((total, 3, 3), dtype=torch.float32, device=dev)
    colors = torch.empty((total, 3, 3), dtype=torch.float32, device=dev)
    if n_listed:
        err = lib.mc_emit(vox.data_ptr(), slots.data_ptr(), nbr_slots.data_ptr(), block_coords.data_ptr(),
                          vox.shape[0], voxel_size, iso, listed.data_ptr(), n_listed, ends.data_ptr(),
                          verts.data_ptr(), colors.data_ptr(), stream)
        _build.check(err, _build.MARCHING_CUBES)
    _build.MARCHING_CUBES.launches += 1
    return verts, colors


def extract_triangles(
    vox: torch.Tensor,
    slots: torch.Tensor,
    nbr_slots: torch.Tensor,
    block_coords: torch.Tensor,
    voxel_size: float,
    iso: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Marching cubes of the blocks at pool rows `slots` (B,) with neighbour
    rows `nbr_slots` (B, 7) (-1 = absent) and coords `block_coords` (B, 3),
    read from the pool `vox` (R, 5, 512) [sdf, weight, r, g, b]. Returns
    (verts (T, 3, 3), colors (T, 3, 3)) float32 on vox's device, in (block,
    voxel, triangle) order. Slots outside [0, R) are absent blocks.

    The CUDA kernel on CUDA tensors (int32 slots and coords), the plain
    version on CPU tensors."""
    args = (vox, slots, nbr_slots, block_coords, voxel_size, iso)
    if vox.is_cuda:
        return _extract_triangles_cuda(*args)
    if vox.device.type == "cpu":
        return extract_triangles_reference(*args)
    raise ValueError(f"extract_triangles: unsupported device {vox.device}")
