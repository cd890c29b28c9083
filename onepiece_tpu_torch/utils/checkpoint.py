"""Whole-SLAM-state checkpoint and resume of the port's device-resident systems.

Port of `onepiece_tpu/utils/checkpoint.py`, in its file format, so that a
checkpoint written by either package loads in the other:

  - `FusedDenseFusion`: the FusedState (frame pyramid, poses, block hash
    table, voxel pool) and the host trajectory (`host_poses`, `host_rmses`);
  - `FusedFBASlam`: the SparseDevState (keyframe DB, poses, edge store,
    failure-ladder scalars), the host records (`host_trels`,
    `host_kf_pose`, anchors, ok and keyframe flags) and the numpy RNG state;
  - `FusedBASlam`: the same plus the TrackState.

Format: one `.npz` holding every state leaf as `leaf<i>`, in the flatten
order of the JAX package's pytree (NamedTuple fields in order), plus a JSON
`meta` with the same keys as the JAX package's. Leaves are written in the
JAX package's dtypes: the port's int64 indices and counters as int32
(checked to fit), its int32 descriptor words as the uint32 they are there,
bit for bit; a load converts back to the port's dtypes. `meta` also holds
the JAX package's `radii` and `interpret` (its defaults; the port has
neither and ignores them on load) and the port's own host state under keys
the JAX package never reads (the grown `kmax`'s history `kmax_growth`, the
touched-key saturation records, the capacity doublings, the last BA mse). A
file re-saved by the JAX package lacks those, and loads with them empty.

Resume is bit-identical: a run that checkpoints after chunk k and resumes in
a fresh instance gives the same poses and state as the uninterrupted run
with the same chunking.
"""

from __future__ import annotations

import json

import numpy as np
import torch

# the JAX package's FusedDenseFusion defaults of the options the port lacks
JAX_RADII = (8, 4, 4)
JAX_INTERPRET = False
_I32 = np.iinfo(np.int32)


def _leaves(state, path: str = "") -> list[tuple[str, torch.Tensor]]:
    """(dotted path, tensor) of every leaf in the JAX pytree flatten order:
    NamedTuple fields and tuple items in order, None holding no leaf."""
    if state is None:
        return []
    if isinstance(state, torch.Tensor):
        return [(path, state)]
    names = getattr(state, "_fields", None) or [str(i) for i in range(len(state))]
    return [leaf for name, sub in zip(names, state) for leaf in _leaves(sub, f"{path}.{name}")]


def _rebuild(template, leaves):
    """template's structure with its tensors replaced, in order, by `leaves`."""
    if template is None:
        return None
    if isinstance(template, torch.Tensor):
        return next(leaves)
    items = [_rebuild(sub, leaves) for sub in template]
    return type(template)(*items) if hasattr(template, "_fields") else type(template)(items)


def _to_jax_dtype(path: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    if path.endswith(".desc"):  # descriptor words: the JAX package's uint32, bit for bit
        return a.view(np.uint32)
    if a.dtype == np.int64:
        if a.size and (a.min() < _I32.min or a.max() > _I32.max):
            raise ValueError(f"checkpoint leaf {path}: int64 values outside int32 ({a.min()}, {a.max()})")
        return a.astype(np.int32)
    return a


def _flatten_state(state) -> dict[str, np.ndarray]:
    return {f"leaf{i}": _to_jax_dtype(p, t) for i, (p, t) in enumerate(_leaves(state))}


def _unflatten_state(template, z, device):
    """template's structure from the saved leaves, in the template's dtypes."""
    out = []
    for i, (path, t) in enumerate(_leaves(template)):
        a = z[f"leaf{i}"]
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint leaf{i} ({path}): shape {a.shape}, expected {tuple(t.shape)}")
        want = torch.empty((), dtype=t.dtype).numpy().dtype
        a = a.view(want) if a.dtype == np.uint32 and want == np.int32 else a.astype(want)
        out.append(torch.as_tensor(a).to(device))
    return _rebuild(template, iter(out))


def _read(path: str, system: str) -> tuple[dict[str, np.ndarray], dict]:
    """(the file's arrays, its meta), checked to hold `system`."""
    with np.load(path, allow_pickle=False) as f:
        z = {k: f[k] for k in f.files}
    meta = json.loads(str(z["meta"]))
    if meta["system"] != system:
        raise ValueError(f"{path}: a {meta['system']} checkpoint, expected {system}")
    return z, meta


def _stack(tensors: list[torch.Tensor], shape: tuple, dtype=np.float32) -> np.ndarray:
    return torch.stack(tensors).cpu().numpy() if tensors else np.zeros(shape, dtype)


# -- FusedDenseFusion ---------------------------------------------------------


def save_dense(slam, path: str) -> None:
    """Checkpoint a FusedDenseFusion mid-run (poses, pool, table, pyramid)."""
    if slam._state is None:
        raise ValueError("checkpoint before any frame was processed")
    meta = {
        "system": "fused_dense",
        "frame_count": slam.frame_count,
        "capacity": slam.capacity,
        "table_size": slam.table_size,
        "kmax": slam.kmax,
        "stride": slam.stride,
        "voxel_size": slam.voxel_size,
        "truncation": slam.truncation,
        "iters": list(slam.iters),
        "radii": list(JAX_RADII),
        "interpret": JAX_INTERPRET,
        # the port's own host state
        "kmax_growth": [list(g) for g in slam.kmax_growth],
        "sat": _stack(slam._sat, (0,), bool).tolist(),
        "sat_checked": slam._sat_checked,
    }
    arrs = _flatten_state(slam._state)
    arrs["host_poses"] = _stack(slam._poses, (0, 4, 4))
    arrs["host_rmses"] = _stack(slam._rmses, (0,))
    np.savez_compressed(path, meta=json.dumps(meta), **arrs)


def load_dense(path: str, camera, device="cuda"):
    """Restore a FusedDenseFusion on `device`; it continues exactly where it
    left off."""
    from ..integration import device_hash as dh
    from ..odometry import dense
    from ..ops import tsdf_slots
    from ..systems.fused_slam import FusedDenseFusion, FusedState

    z, meta = _read(path, "fused_dense")
    slam = FusedDenseFusion(
        camera, device=device, voxel_size=meta["voxel_size"], truncation=meta["truncation"],
        capacity=meta["capacity"], table_size=meta["table_size"], kmax=meta["kmax"], stride=meta["stride"],
        iters=tuple(meta["iters"]),
    )
    # the structure and shapes, on no device
    cams = camera.pyramid(dense.DEFAULT_LEVELS)

    def planes(*trailing):
        return tuple(torch.empty((c.height, c.width, *trailing), device="meta") for c in cams)

    eye = torch.empty((4, 4), device="meta")
    template = FusedState(
        pyr=dense.FramePyramid(planes(), planes(), planes(3)), T_w=eye, rel=eye,
        table=dh.make_table(meta["table_size"], meta["capacity"], "meta"),
        vox=tsdf_slots.make_pool(meta["capacity"], "meta"),
    )
    dev = slam.device
    slam._state = _unflatten_state(template, z, dev)
    slam.frame_count = meta["frame_count"]
    slam._poses = list(torch.from_numpy(z["host_poses"].astype(np.float32)).to(dev))
    slam._rmses = list(torch.from_numpy(z["host_rmses"].astype(np.float32)).to(dev))
    slam.kmax_growth = [tuple(g) for g in meta.get("kmax_growth", [])]
    slam._sat = list(torch.tensor(meta.get("sat", []), dtype=torch.bool).to(dev))
    slam._sat_checked = meta.get("sat_checked", 0)
    return slam


# -- FusedFBASlam and FusedBASlam ---------------------------------------------

_SPARSE_CONFIG = ("kf_capacity", "edge_capacity", "corr_capacity", "max_keypoints", "fast_threshold",
                  "keyframe_disparity", "num_hypotheses")
_SPARSE_COUNTERS = ("frame_count", "num_kf", "num_edges", "edge_overflow", "lc_edges_total")
_BA_CONFIG = ("pt_capacity", "obs_capacity", "ba_iters", "ba_lam0", "ba_every_chunks", "residual")
_BA_COUNTERS = ("n_pts", "n_obs", "pt_overflow", "obs_overflow")


def _sparse_meta(slam, system: str) -> dict:
    meta = {"system": system}
    meta.update({k: getattr(slam, k) for k in _SPARSE_COUNTERS + _SPARSE_CONFIG})
    meta.update(anchors=slam._anchors, ok=slam._ok, iskf=slam._iskf, rng_state=slam._rng.bit_generator.state,
                capacity_doublings=slam.capacity_doublings)
    return meta


def _sparse_arrays(slam, state) -> dict[str, np.ndarray]:
    arrs = _flatten_state(state)
    arrs["host_trels"] = np.stack(slam._Trels) if slam._Trels else np.zeros((0, 4, 4), np.float32)
    arrs["host_kf_pose"] = slam._kf_pose
    return arrs


def _restore_sparse_host(slam, z, meta) -> None:
    for k in _SPARSE_COUNTERS:
        setattr(slam, k, meta[k])
    slam._anchors = list(meta["anchors"])
    slam._ok = list(meta["ok"])
    slam._iskf = list(meta["iskf"])
    slam._Trels = [t.astype(np.float32) for t in z["host_trels"]]
    slam._kf_pose = z["host_kf_pose"].astype(np.float32)
    slam._rng.bit_generator.state = meta["rng_state"]
    slam.capacity_doublings = meta.get("capacity_doublings", 0)


def save_sparse(slam, path: str) -> None:
    """Checkpoint a FusedFBASlam mid-run (keyframe DB, edges, anchors, RNG)."""
    np.savez_compressed(path, meta=json.dumps(_sparse_meta(slam, "fused_sparse")),
                        **_sparse_arrays(slam, slam._state))


def load_sparse(path: str, camera, device="cuda"):
    """Restore a FusedFBASlam on `device`; it continues exactly where it left off."""
    from ..systems.fused_sparse import FusedFBASlam

    z, meta = _read(path, "fused_sparse")
    slam = FusedFBASlam(camera, device=device, **{k: meta[k] for k in _SPARSE_CONFIG})
    slam._state = _unflatten_state(slam._state, z, slam.device)
    _restore_sparse_host(slam, z, meta)
    return slam


def save_ba(slam, path: str) -> None:
    """Checkpoint a FusedBASlam: the sparse state + the track store."""
    meta = _sparse_meta(slam, "fused_ba")
    meta.update({k: getattr(slam, k) for k in _BA_CONFIG + _BA_COUNTERS})
    meta.update(chunks=slam._chunks, ba_mse=slam.ba_mse)
    np.savez_compressed(path, meta=json.dumps(meta), **_sparse_arrays(slam, (slam._state, slam._track_state)))


def load_ba(path: str, camera, device="cuda"):
    """Restore a FusedBASlam on `device`; it continues exactly where it left off."""
    from ..systems.fused_ba import FusedBASlam

    z, meta = _read(path, "fused_ba")
    slam = FusedBASlam(camera, device=device, **{k: meta[k] for k in _SPARSE_CONFIG + _BA_CONFIG})
    slam._state, slam._track_state = _unflatten_state((slam._state, slam._track_state), z, slam.device)
    _restore_sparse_host(slam, z, meta)
    for k in _BA_COUNTERS:
        setattr(slam, k, meta[k])
    slam._chunks = meta["chunks"]
    slam.ba_mse = meta.get("ba_mse", 0.0)
    return slam


def save(slam, path: str) -> None:
    """Dispatch on the system's type."""
    from ..systems.fused_ba import FusedBASlam
    from ..systems.fused_slam import FusedDenseFusion
    from ..systems.fused_sparse import FusedFBASlam

    if isinstance(slam, FusedDenseFusion):
        save_dense(slam, path)
    elif isinstance(slam, FusedBASlam):  # before FusedFBASlam: a subclass
        save_ba(slam, path)
    elif isinstance(slam, FusedFBASlam):
        save_sparse(slam, path)
    else:
        raise TypeError(f"no checkpoint support for {type(slam)}")


def load(path: str, camera, device="cuda"):
    """Restore whichever system the checkpoint holds, on `device`."""
    loaders = {"fused_dense": load_dense, "fused_sparse": load_sparse, "fused_ba": load_ba}
    with np.load(path, allow_pickle=False) as z:
        system = json.loads(str(z["meta"]))["system"]
    if system not in loaders:
        raise ValueError(f"unknown checkpoint system {system}")
    return loaders[system](path, camera, device)
