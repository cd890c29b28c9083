"""Build and load the port's host-side C++ libraries, one for each source in
`native/`: `mesh_native.cpp` (QEM simplification and connected-component
pruning: a global priority queue and a union-find), `jpeg_decode.cpp` (the
baseline JPEG decoder: a serial Huffman bit walk) and `remap.cpp` (bilinear
resampling with cv2.remap's float arithmetic) -- sequential work that stays
on the host CPU.

g++ compiles each at first use into `build/native/` at the repository root
(git-ignored, beside the CUDA kernels' `build/kernels/`), named by a hash of
the source and the flags, with the JAX package's flags
(`onepiece_tpu/native/__init__.py`), so on one machine the port's and the
JAX package's mesh libraries give bit-equal outputs. Nothing here runs at
import. A missing compiler or a failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
MESH_SOURCE = PACKAGE_DIR / "native" / "mesh_native.cpp"
JPEG_SOURCE = PACKAGE_DIR / "native" / "jpeg_decode.cpp"
REMAP_SOURCE = PACKAGE_DIR / "native" / "remap.cpp"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "native"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    # verts (V, 3), V, faces (F, 3), F, target faces, out verts, out V, out faces, out F
    "qem_simplify": [_FP, ctypes.c_int, _IP, ctypes.c_int, ctypes.c_int, _FP, _IP, _IP, _IP],
    # faces (F, 3), F, V, min faces, keep (F,) uint8
    "prune_components": [_IP, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)],
}

_loaded: dict[Path, ctypes.CDLL] = {}


def library_path(source: Path) -> Path:
    """Where `source` is built."""
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:16]}.so"


def build(source: Path) -> Path:
    """Compile `source` unless it is built."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        res = subprocess.run(["g++", *GXX_FLAGS, str(source), "-o", str(tmp)], capture_output=True, text=True)
    except FileNotFoundError:
        raise RuntimeError(f"g++ not found: the native library {source.name} cannot be built") from None
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {source.name} ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


def load(source: Path, signatures: dict) -> ctypes.CDLL:
    """The library of `source`, built and loaded on its first call, each
    function of `signatures` given its argument types and an int result."""
    lib = _loaded.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build(source)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[source] = lib
    return lib


def mesh_library() -> ctypes.CDLL:
    """The loaded mesh library (built on first use)."""
    return load(MESH_SOURCE, _SIGNATURES)
