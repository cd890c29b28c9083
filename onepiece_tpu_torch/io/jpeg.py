"""Baseline JPEG decoding through the port's native decoder
(`native/jpeg_decode.cpp`, built by `_native.py`).

ScanNet stores colour as JPEG and the card's machine has neither OpenCV nor
PIL. The decoder reproduces libjpeg-turbo's default decompression, what
`cv2.imdecode` runs (its accurate integer IDCT, fancy chroma upsampling and
fixed-point YCbCr -> RGB), bit for bit; its output is RGB where cv2's is
BGR. Supported: baseline (SOF0) Huffman DCT, 8-bit, one gray or three
YCbCr components in one scan, sampling 4:4:4 / 4:2:2 / 4:2:0, restart
intervals, any size. Anything else (extended sequential, progressive,
arithmetic coding, lossless, 12-bit, RGB- or CMYK-coded colour, multi-scan
files) and every truncated or corrupt stream raises `ValueError`; there is
no fallback. EXIF orientation is not applied (cv2.imread would apply it;
ScanNet's JPEGs carry none).
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import _native

_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    # data, size, out height, out width, out channels, err, err length
    "jpeg_info": [ctypes.c_char_p, ctypes.c_int64, _IP, _IP, _IP, ctypes.c_char_p, ctypes.c_int],
    # data, size, out pixels, out size, err, err length
    "jpeg_decode": [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int],
}


def decode(data: bytes) -> np.ndarray:
    """A JPEG stream -> (H, W, 3) uint8 RGB, or (H, W) uint8 for gray."""
    lib = _native.load(_native.JPEG_SOURCE, _SIGNATURES)
    err = ctypes.create_string_buffer(256)
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.jpeg_info(data, len(data), h, w, c, err, len(err)):
        raise ValueError(err.value.decode())
    shape = (h.value, w.value) if c.value == 1 else (h.value, w.value, c.value)
    out = np.empty(shape, np.uint8)
    if lib.jpeg_decode(data, len(data), out.ctypes.data, out.size, err, len(err)):
        raise ValueError(err.value.decode())
    return out


def read_jpeg(path: str) -> np.ndarray:
    """`decode` of a file; a failure names it."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
