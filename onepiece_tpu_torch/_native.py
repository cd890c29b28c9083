"""Build and load the port's host-side C++ library, `native/mesh_native.cpp`
(QEM simplification and connected-component pruning: a global priority
queue and a union-find, sequential algorithms that stay on the host CPU).

g++ compiles it at first use into `build/native/` at the repository root
(git-ignored, beside the CUDA kernels' `build/kernels/`), named by a hash of
the source and the flags, with the JAX package's flags
(`onepiece_tpu/native/__init__.py`), so on one machine the two libraries
give bit-equal outputs. Nothing here runs at import. A missing compiler or a
failed build raises; there is no numpy fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
MESH_SOURCE = PACKAGE_DIR / "native" / "mesh_native.cpp"
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

_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    h = hashlib.sha256(MESH_SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libmesh_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is already there."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        res = subprocess.run(["g++", *GXX_FLAGS, str(MESH_SOURCE), "-o", str(tmp)], capture_output=True, text=True)
    except FileNotFoundError:
        raise RuntimeError("g++ not found: the native mesh library cannot be built") from None
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {MESH_SOURCE.name} ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


def mesh_library() -> ctypes.CDLL:
    """The loaded mesh library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for fn, argtypes in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _lib = lib
    return _lib
