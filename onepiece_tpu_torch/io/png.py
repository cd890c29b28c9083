"""PNG decode and encode with the standard library's `zlib` and numpy.

The port's counterpart of the libpng decode of
`onepiece_tpu/native/rgbd_loader.cpp` (`decode_png`) and of the
`cv2.imwrite` calls of `onepiece_tpu/io/tum.py`'s writer: the card's
machine has neither libpng bindings nor OpenCV, and TUM sequences are PNG
files (16-bit gray depth, 8-bit RGB colour).

Decode checks the signature and every chunk's CRC, joins and inflates the
IDAT chunks and undoes the five row filters. Supported pixel types: 8-bit
gray, gray + alpha, RGB and RGBA, and 16-bit gray (big-endian on disk,
returned as native uint16). Anything else (palette, Adam7 interlace, other
bit depths, transparency chunks) raises `ValueError` naming the feature;
there is no fallback to another decoder.

Average and Paeth are serial along a row: pixel (r, x) needs (r, x - 1),
(r - 1, x) and (r - 1, x - 1). So the image is decoded in one sweep over
the anti-diagonals r + x = d (H + W vector steps); each step computes the
predictions of the filters in use and selects by each row's filter byte.
`decode_many` stacks images of one size as channels of one image, so that
they share the sweep's steps.

Encode writes what a TUM folder holds: 8-bit RGB and 16-bit gray. Each
row's filter is libpng's default heuristic, the smallest sum of absolute
signed bytes, so the port's own files carry every filter type.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
NONE, SUB, UP, AVERAGE, PAETH = range(5)
# PNG colour type -> channels
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}
_COLOR_NAMES = {3: "palette (colour type 3)"}
_CRITICAL = {b"IHDR", b"PLTE", b"IDAT", b"IEND"}
_UNSUPPORTED_ANCILLARY = {b"tRNS": "tRNS transparency"}


def _chunks(data: bytes):
    """(type, payload) of each chunk, with its CRC checked."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file: bad signature")
    at = 8
    while at < len(data):
        if at + 8 > len(data):
            raise ValueError("truncated PNG chunk header")
        (n,) = struct.unpack(">I", data[at : at + 4])
        kind = data[at + 4 : at + 8]
        end = at + 8 + n
        if end + 4 > len(data):
            raise ValueError(f"truncated PNG chunk {kind!r}")
        payload = data[at + 8 : end]
        (crc,) = struct.unpack(">I", data[end : end + 4])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, payload
        if kind == b"IEND":
            return
        at = end + 4
    raise ValueError("PNG file has no IEND chunk")


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor of int16 arrays a (left), b (up), c (upper left)."""
    bc = b - c
    ac = a - c
    pa = np.abs(bc)  # |p - a| with p = a + b - c
    pb = np.abs(ac)  # |p - b|
    pc = np.abs(bc + ac)  # |p - c|
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(kinds: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Filtered bytes (H, W, C) with each row's filter per channel (H, C)
    -> the image's bytes (H, W, C), by a sweep over the anti-diagonals.
    T[s, j] holds pixel (j - 1, s - 1 - j): row j - 1 (j = 0 is the zero
    row above the image) on diagonal d = s - 2; entries left of x = 0 stay
    0, as PNG's neighbours outside the image are. Each step selects its
    rows' predictions with masks of the step's full shape (numpy broadcasts
    a (k, 1) mask several times slower). The skewed layout is a strided
    view of the rows padded with zeros, and the result a strided view of T."""
    k, w, c = data.shape
    if kinds.size and int(kinds.max()) > PAETH:
        raise ValueError(f"PNG row filter type {int(kinds.max())} does not exist")
    n_s = k + w + 1
    padded = np.zeros((k + 1, 2 * k + 1 + w, c), np.int16)
    padded[1:, k + 1 : k + 1 + w] = data
    e, row_stride = padded.strides[2], padded.strides[0]
    skew = np.lib.stride_tricks.as_strided(padded[0, k:], (n_s, k + 1, c), (c * e, row_stride - c * e, e))
    T = np.zeros((n_s, k + 1, c), np.int16)
    raw = np.ascontiguousarray(skew[:, 1:])
    mask = {f: (kinds == f).astype(np.int16) for f in (SUB, UP, AVERAGE, PAETH)}
    used = [f for f, m in mask.items() if m.any()]
    for st in range(2, n_s):
        a = T[st - 1, 1:]
        b = T[st - 1, :-1]
        pred = raw[st].copy()
        for f in used:
            if f == SUB:
                pred += mask[SUB] * a
            elif f == UP:
                pred += mask[UP] * b
            elif f == AVERAGE:
                pred += mask[AVERAGE] * ((a + b) >> 1)
            else:
                pred += mask[PAETH] * _paeth(a, b, T[st - 2, :-1])
        np.bitwise_and(pred, 255, out=T[st, 1:])
    t0, t1, t2 = T.strides
    out = np.lib.stride_tricks.as_strided(T[2, 1:], (k, w, c), (t0 + t1, t0, t2))  # pixel (i, x) = T[i + x + 2, i + 1]
    return out.astype(np.uint8)


def _inflate(data: bytes) -> tuple[tuple, np.ndarray]:
    """A PNG file's bytes -> ((width, height, depth, channels), its filtered
    scanlines (H, 1 + W bpp) uint8), every chunk's CRC and the pixel type
    checked."""
    header = None
    idat = []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind in _UNSUPPORTED_ANCILLARY:
            raise ValueError(f"PNG feature not supported: {_UNSUPPORTED_ANCILLARY[kind]}")
        elif kind not in _CRITICAL and not kind[0] & 0x20:
            raise ValueError(f"PNG feature not supported: critical chunk {kind!r}")
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    width, height, depth, color, compression, filtering, interlace = header
    if color not in _CHANNELS:
        raise ValueError(f"PNG feature not supported: {_COLOR_NAMES.get(color, f'colour type {color}')}")
    if interlace != 0:
        raise ValueError("PNG feature not supported: Adam7 interlace")
    if compression != 0 or filtering != 0:
        raise ValueError(f"PNG feature not supported: compression {compression}, filter method {filtering}")
    channels = _CHANNELS[color]
    if not (depth == 8 or (depth == 16 and channels == 1)):
        raise ValueError(f"PNG feature not supported: {depth}-bit samples with {channels} channel(s)")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG image data does not inflate: {e}") from None
    stride = 1 + width * channels * depth // 8
    if len(raw) != height * stride:
        raise ValueError(f"PNG image data holds {len(raw)} bytes, expected {height * stride}")
    return (width, height, depth, channels), np.frombuffer(raw, np.uint8).reshape(height, stride)


def image_size(data: bytes) -> tuple[int, int]:
    """(width, height) of a PNG file from its first 33 bytes (the signature
    and the IHDR chunk, its CRC checked)."""
    kind, payload = next(_chunks(data))
    if kind != b"IHDR":
        raise ValueError("PNG file does not start with an IHDR chunk")
    return struct.unpack(">II", payload[:8])


def _named(name: str | None, e: ValueError) -> ValueError:
    return ValueError(f"{name}: {e}") if name else e


def decode_many(datas: list[bytes], names: list[str] | None = None) -> list[np.ndarray]:
    """`decode` of several PNG files. Images of one width and height are
    undone together, their bytes side by side as channels of one image, so
    the sweep's numpy steps are shared (a TUM frame's depth and colour, or a
    batch of frames). `names` (the files' paths) prefix the messages of the
    errors raised."""
    names = names or [None] * len(datas)
    parsed = []
    for d, name in zip(datas, names):
        try:
            parsed.append(_inflate(d))
        except ValueError as e:
            raise _named(name, e) from None
    out: list[np.ndarray | None] = [None] * len(datas)
    groups: dict[tuple[int, int], list[int]] = {}
    for i, ((w, h, _, _), _) in enumerate(parsed):
        groups.setdefault((w, h), []).append(i)
    for (w, h), idx in groups.items():
        bpps = [parsed[i][0][2] // 8 * parsed[i][0][3] for i in idx]
        data = np.concatenate([parsed[i][1][:, 1:].reshape(h, w, bpp) for i, bpp in zip(idx, bpps)], axis=2)
        kinds = np.concatenate([np.repeat(parsed[i][1][:, :1], bpp, axis=1) for i, bpp in zip(idx, bpps)], axis=1)
        try:
            px = _unfilter(kinds, data)
        except ValueError as e:
            raise _named(", ".join(n for n in (names[i] for i in idx) if n), e) from None
        at = 0
        for i, bpp in zip(idx, bpps):
            (_, _, depth, channels), _ = parsed[i]
            img = px[:, :, at : at + bpp]
            at += bpp
            if depth == 16:
                out[i] = np.ascontiguousarray(img).view(">u2").astype(np.uint16).reshape(h, w)
            else:
                out[i] = img.reshape(h, w) if channels == 1 else np.ascontiguousarray(img)
    return out


def decode(data: bytes) -> np.ndarray:
    """A PNG file's bytes -> (H, W) for gray, else (H, W, C) with C = 2
    (gray + alpha), 3 (RGB) or 4 (RGBA); uint8, or uint16 for 16-bit gray."""
    return decode_many([data])[0]


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())


def _filtered(px: np.ndarray, bpp: int) -> np.ndarray:
    """(5, H, S) uint8: every row under each of the five filters, from the
    unfiltered bytes px (H, S)."""
    x = px.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    preds = (0, a, b, (a + b) >> 1, _paeth(a, b, c))
    return np.stack([(x - p) & 255 for p in preds]).astype(np.uint8)


def _choose_filters(filt: np.ndarray) -> np.ndarray:
    """libpng's default heuristic: each row's filter is the one whose bytes
    (filt from `_filtered`) have the smallest sum of absolute signed values."""
    return np.argmin(np.minimum(filt, 256 - filt.astype(np.int32)).sum(axis=2), axis=0)


def _pack(filt: np.ndarray, kinds: np.ndarray, depth: int, channels: int, level: int) -> bytes:
    """PNG bytes of the rows filt (5, H, S) from `_filtered`, row r under
    filter kinds[r]; `level` is zlib's compression level."""
    height, width = filt.shape[1], filt.shape[2] * 8 // (depth * channels)
    rows = filt[kinds, np.arange(height)]
    raw = np.concatenate([kinds.astype(np.uint8)[:, None], rows], axis=1)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return struct.pack(">I", len(payload)) + kind + payload + struct.pack(">I", zlib.crc32(kind + payload))

    ihdr = struct.pack(">IIBBBBB", width, height, depth, _COLOR_TYPE[channels], 0, 0, 0)
    return (SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + chunk(b"IEND", b""))


def encode(img: np.ndarray, level: int = 6) -> bytes:
    """A TUM image -> PNG bytes: uint8 (H, W, 3) RGB colour or uint16 (H, W)
    depth. Each row takes the filter with the smallest sum of absolute signed
    bytes (libpng's default). `level` is zlib's compression level."""
    img = np.asarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        depth, channels = 16, 1
        px = img.astype(">u2").view(np.uint8).reshape(img.shape[0], -1)
    elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        depth, channels = 8, 3
        px = np.ascontiguousarray(img).reshape(img.shape[0], -1)
    else:
        raise ValueError(f"cannot encode a {img.dtype} image of shape {img.shape} as PNG (8-bit RGB or 16-bit gray)")
    filt = _filtered(px, channels * depth // 8)
    return _pack(filt, _choose_filters(filt), depth, channels, level)


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode(img))
