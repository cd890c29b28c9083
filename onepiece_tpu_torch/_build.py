"""Build and load the hand-written CUDA kernels of `csrc/`.

All `csrc/*.cu` files compile with `nvcc` for Hopper (`sm_90a`), in
parallel, into ONE shared library with a plain C interface, loaded with
`ctypes` (no PyTorch headers, so a build takes seconds). The library lands in `build/kernels/`
at the repository root, named by a hash of the sources and flags, so an
edited kernel rebuilds and an unchanged one loads at once.

Nothing here runs at import: the CPU tests import every module of the port
on machines without `nvcc`. A missing compiler or a failed build raises;
there is no fallback to the plain PyTorch versions.

Each kernel keeps a plain-integer launch count. A wrapper adds one where it
launches its kernel and nowhere else, so a run can show which kernels the
main path went through.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

# --fmad=false: no fused multiply-add contraction, so every product and sum
# rounds exactly as the plain PyTorch version's separate elementwise ops
# do. Projections then land on bit-identical pixels in kernel and plain
# version, and the discrete outcomes (updated voxels, inlier counts) agree
# exactly.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "--fmad=false",
)


@dataclasses.dataclass
class Kernel:
    """One hand-written kernel: where it lives, what it replaces, its count."""

    name: str
    source: str  # path in the repository
    replaces: str  # file:line of the TPU kernel (or XLA op) it ports
    launches: int = 0


TSDF_INTEGRATE = Kernel(
    "tsdf_integrate",
    "onepiece_tpu_torch/csrc/tsdf_integrate.cu",
    "onepiece_tpu/ops/tsdf_pallas.py:253",
)
DENSE_NORMAL_EQ = Kernel(
    "dense_normal_eq",
    "onepiece_tpu_torch/csrc/dense_normal_eq.cu",
    "onepiece_tpu/ops/dense_odometry.py:80",
)
NN1 = Kernel(
    "nn1",
    "onepiece_tpu_torch/csrc/nn1.cu",
    "onepiece_tpu/ops/knn_pallas.py:69",
)
MARCHING_CUBES = Kernel(
    "marching_cubes",
    "onepiece_tpu_torch/csrc/marching_cubes.cu",
    "onepiece_tpu/ops/marching_cubes.py:82",
)
HAMMING = Kernel(
    "hamming",
    "onepiece_tpu_torch/csrc/hamming.cu",
    "onepiece_tpu/ops/hamming.py:41 hamming_table (XLA, not Pallas) and its consumers :52, :78, "
    "lcdetection/mild.py:55",
)
BA_SCHUR = Kernel(
    "ba_schur",
    "onepiece_tpu_torch/csrc/ba_schur.cu",
    "onepiece_tpu/optimization/bundle.py:232",
)
KERNELS = (TSDF_INTEGRATE, DENSE_NORMAL_EQ, NN1, MARCHING_CUBES, HAMMING, BA_SCHUR)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME (default /usr/local/cuda)."""
    nvcc = shutil.which("nvcc") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libonepiece_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile `csrc/*.cu` into the shared library unless it is already
    there: one nvcc per source, all started together, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_suffix(f".{src.stem}.o") for src in _sources()]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for src, obj in zip(_sources(), objs)
    ]
    try:
        for src, proc in zip(_sources(), procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{err}")
            if verbose:
                print(err, end="")
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, out)
    finally:
        for proc in procs:  # a failed source leaves no compiler running
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # vox, keys, slots, K, rows, img, channels (2 or 4), H, W, T_cw, fx, fy, cx, cy, voxel,
    # trunc, max_w, stream
    "tsdf_integrate": [_VP, _VP, _VP, _I, _I, _VP, _I, _I, _I, _VP, _F, _F, _F, _F, _F, _F, _F, _VP],
    # src (N, 4), N, tex (H, W, 8), H, W, T, fx, fy, cx, cy, wi, wz, ddm,
    # damping, update, iters, partials, partial_rows, counter, out, stream
    "dense_gn": [
        _VP, _I, _VP, _I, _I, _VP, _F, _F, _F, _F, _F, _F, _F, _F, _I, _I, _VP, _I, _VP, _VP, _VP,
    ],
    # query, ref, ref_valid, N, M, out_idx, out_d2, part_d2, part_idx, chunks, stream
    "nn1": [_VP, _VP, _VP, _I, _I, _VP, _VP, _VP, _VP, _I, _VP],
    # triangle table (256, 5, 3) int8, counts (256,) uint8, edge corners (12, 2) int8 (host)
    "mc_set_tables": [_VP, _VP, _VP],
    # vox, slots, nbr, B, rows, iso, counts, list (B + 1), stream
    "mc_count": [_VP, _VP, _VP, _I, _I, _F, _VP, _VP, _VP],
    # vox, slots, nbr, coords, rows, voxel, iso, list, listed, ends, verts, colors, stream
    "mc_emit": [_VP, _VP, _VP, _VP, _I, _F, _F, _VP, _I, _VP, _VP, _VP, _VP],
    # a, b, valid_b, uv_pred (or null), uv_b (or null), window, N, M, best (int64), dist (2, N), stream
    "hamming_match": [_VP, _VP, _VP, _VP, _VP, _F, _I, _I, _VP, _VP, _VP],
    # a, b, N, M, out (N, M), stream
    "hamming_table": [_VP, _VP, _I, _I, _VP, _VP],
    # q_desc, q_valid, db, db_valid, g (device int64), lut (64,), N, N_CAP, F, fs, stream
    "mild_feature_scores": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _VP, _VP],
    # poses, points, frame, point, uv or pc_obs, model (0 2-D, 1 RGB-D), lam (device), fx, fy, cx, cy,
    # frame_ptr, frame_obs, point_ptr, point_obs, frame_point, live_frames, num_live (device), F, P, S, rhs, Vinv,
    # b_p, per-observation scratch, stream
    "ba_schur": [
        _VP, _VP, _VP, _VP, _VP, _I, _VP, _F, _F, _F, _F, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _VP, _VP, _VP,
        _VP, _VP, _VP,
    ],
    # frame, point_ptr, point_obs, per-observation scratch, Vinv, b_p, dc, P, dp, stream
    "ba_back_substitute": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _VP, _VP],
}

_lib: ctypes.CDLL | None = None


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for fn, argtypes in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, kernel: Kernel) -> None:
    """Raise on the cudaError_t a launch returned."""
    if err != 0:
        raise RuntimeError(f"{kernel.name}: CUDA launch failed with cudaError_t {err}")


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple, device, align: int = 1) -> None:
    """Check what a kernel takes: device, dtype, shape (None = any),
    contiguity, and the address's alignment in bytes where the kernel reads
    vectors."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if len(t.shape) != len(shape) or any(
        s is not None and s != d for s, d in zip(shape, t.shape)
    ):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: address not aligned to {align} bytes")
