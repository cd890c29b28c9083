"""Binary PGM (P5) reader: ScanNet's `frame-XXXXXX.depth.pgm`.

Returns what `cv2.imread(path, cv2.IMREAD_UNCHANGED)` returns for such a
file (the JAX package's reader, `onepiece_tpu/io/scannet.py`): the raw
samples as uint8 when maxval <= 255, else big-endian 16-bit samples as
native uint16, never rescaled by maxval. The header may hold `#` comments
and any whitespace; one whitespace byte ends it. Other PNM kinds, a bad
header and a short file raise `ValueError` naming the file.
"""

from __future__ import annotations

import numpy as np

_WHITESPACE = b" \t\r\n\v\f"


def decode(data: bytes) -> np.ndarray:
    """A P5 file's bytes -> (H, W) uint8 or uint16."""
    if data[:2] != b"P5":
        raise ValueError(f"not a binary PGM (P5) file: magic {data[:2]!r}")
    at, fields = 2, []
    while len(fields) < 3:
        if at >= len(data):
            raise ValueError("truncated PGM header")
        c = data[at : at + 1]
        if c in _WHITESPACE:
            at += 1
        elif c == b"#":
            end = data.find(b"\n", at)
            at = len(data) if end < 0 else end + 1
        else:
            start = at
            while at < len(data) and data[at : at + 1] not in _WHITESPACE and data[at : at + 1] != b"#":
                at += 1
            if not data[start:at].isdigit():
                raise ValueError(f"bad PGM header field {data[start:at]!r}")
            fields.append(int(data[start:at]))
    if at >= len(data) or data[at : at + 1] not in _WHITESPACE:
        raise ValueError("truncated PGM header")
    w, h, maxval = fields
    if w < 1 or h < 1 or not 0 < maxval <= 65535:
        raise ValueError(f"bad PGM size {w}x{h} or maxval {maxval}")
    dtype = np.dtype(np.uint8) if maxval <= 255 else np.dtype(">u2")
    n = w * h * dtype.itemsize
    pixels = data[at + 1 : at + 1 + n]
    if len(pixels) < n:
        raise ValueError(f"truncated PGM data: {len(pixels)} of {n} bytes")
    return np.frombuffer(pixels, dtype).reshape(h, w).astype(dtype.newbyteorder("="))


def read_pgm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
