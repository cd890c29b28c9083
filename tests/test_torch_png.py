"""The port's PNG codec (`onepiece_tpu_torch/io/png.py`) against itself and
against OpenCV, the encoder of the JAX package's TUM writer.

- Round trips of seeded random images: uint8 gray, gray + alpha, RGB and
  RGBA, and uint16 depth holding 0 and 65535, at widths 1, 3 and 641, with
  each of the five row filters forced and with the default heuristic; a
  mixed list through `decode_many` equals each image decoded alone. The
  port's encoder writes only what a TUM folder holds (8-bit RGB, 16-bit
  gray), so `encode_any` here packs the other pixel types, and the forced
  filters, through the codec's own filter and chunk helpers; for RGB and
  depth under the heuristic its bytes are `png.encode`'s.
- PNGs written by `cv2.imwrite` with each of the five filters decode to
  exactly what `cv2.imread(..., IMREAD_UNCHANGED)` returns (the files are
  checked to hold the filter); the port's PNGs decode in OpenCV to the
  source arrays.
- A bad CRC, a palette file, an interlaced file and 16-bit RGB raise
  `ValueError` naming what is wrong, as does encoding a pixel type that a
  TUM folder does not hold.
- `tools/compare_torch_png.py` runs on the CPU, this tree against itself.
"""

import json
import struct
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from onepiece_tpu_torch.io import png

FILTERS = [None, png.NONE, png.SUB, png.UP, png.AVERAGE, png.PAETH]
KINDS = {"gray8": (np.uint8, ()), "gray_alpha": (np.uint8, (2,)), "rgb": (np.uint8, (3,)),
         "rgba": (np.uint8, (4,)), "depth16": (np.uint16, ())}
CV2_FILTERS = {png.NONE: cv2.IMWRITE_PNG_FILTER_NONE, png.SUB: cv2.IMWRITE_PNG_FILTER_SUB,
               png.UP: cv2.IMWRITE_PNG_FILTER_UP, png.AVERAGE: cv2.IMWRITE_PNG_FILTER_AVG,
               png.PAETH: cv2.IMWRITE_PNG_FILTER_PAETH}


def image(kind: str, width: int, height: int = 7, seed: int = 0) -> np.ndarray:
    dtype, trailing = KINDS[kind]
    rng = np.random.default_rng(seed)
    img = rng.integers(0, np.iinfo(dtype).max + 1, (height, width, *trailing), dtype=np.int64).astype(dtype)
    if kind == "depth16":  # a smooth ramp with the extremes, so the filters see real differences
        img[: height // 2] = (np.arange(width) * 97 + np.arange(height // 2)[:, None] * 1031) % 65536
        img.flat[0], img.flat[-1] = 0, 65535
    return img


def encode_any(img: np.ndarray, filter_type: int | None = None) -> bytes:
    """PNG bytes of any decodable pixel type, each row under filter_type or,
    for None, libpng's heuristic as `png.encode` chooses it."""
    if img.dtype == np.uint16:
        depth, channels, px = 16, 1, img.astype(">u2").view(np.uint8).reshape(img.shape[0], -1)
    else:
        depth, channels, px = 8, 1 if img.ndim == 2 else img.shape[2], img.reshape(img.shape[0], -1)
    filt = png._filtered(px, channels * depth // 8)
    kinds = png._choose_filters(filt) if filter_type is None else np.full(img.shape[0], filter_type)
    return png._pack(filt, kinds, depth, channels, 6)


def row_filters(data: bytes) -> np.ndarray:
    """The filter byte of every row of a non-interlaced PNG."""
    (h,) = struct.unpack(">I", dict(png._chunks(data))[b"IHDR"][4:8])
    raw = zlib.decompress(b"".join(p for k, p in png._chunks(data) if k == b"IDAT"))
    return np.frombuffer(raw, np.uint8).reshape(h, -1)[:, 0]


def to_cv2(img: np.ndarray) -> np.ndarray:
    """RGB(A) -> OpenCV's BGR(A) channel order."""
    return img if img.ndim == 2 else img[..., [2, 1, 0, 3][: img.shape[2]]]


@pytest.mark.parametrize("filter_type", FILTERS)
@pytest.mark.parametrize("width", [1, 3, 641])
@pytest.mark.parametrize("kind", list(KINDS))
def test_round_trip(kind, width, filter_type):
    img = image(kind, width)
    data = encode_any(img, filter_type)
    if filter_type is None and kind in ("rgb", "depth16"):
        assert data == png.encode(img)
    out = png.decode(data)
    assert out.dtype == img.dtype and out.shape == img.shape
    assert np.array_equal(out, img)
    if filter_type is not None:
        assert set(row_filters(data).tolist()) == {filter_type}


def test_decode_many_equals_decode():
    """Images of one size are undone together as channels of one image: the
    result equals each image decoded alone, whatever the mix of sizes,
    sample types and filters."""
    kinds = ["rgb", "depth16", "gray8", "rgba", "gray_alpha", "depth16", "rgb"]
    widths = [641, 641, 641, 3, 641, 1, 3]
    filters = [png.PAETH, png.AVERAGE, None, png.SUB, png.UP, png.PAETH, png.NONE]
    imgs = [image(k, w, seed=i) for i, (k, w) in enumerate(zip(kinds, widths))]
    datas = [encode_any(im, f) for im, f in zip(imgs, filters)]
    for got, data, img in zip(png.decode_many(datas), datas, imgs):
        assert got.dtype == img.dtype and np.array_equal(got, img) and np.array_equal(got, png.decode(data))


def test_heuristic_uses_every_filter():
    """libpng's minimum-sum heuristic picks all five filters on a mixed image."""
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:40, 0:64]
    img = np.zeros((40, 64, 3), np.uint8)
    img[:8] = 17  # flat: None
    img[8:16] = (xx[8:16, :, None] * 3) % 256  # horizontal ramp: Sub
    img[16:24] = rng.integers(0, 256, (1, 64, 3))  # repeated rows: Up
    img[24:32] = ((xx[24:32] + yy[24:32]) * 5 % 256)[..., None]  # diagonal ramp: Average / Paeth
    img[32:] = rng.integers(0, 256, (8, 64, 3))
    used = set(row_filters(png.encode(img)).tolist())
    assert {png.NONE, png.SUB, png.UP} <= used and used & {png.AVERAGE, png.PAETH}
    assert np.array_equal(png.decode(png.encode(img)), img)


@pytest.mark.parametrize("filter_type", list(CV2_FILTERS))
@pytest.mark.parametrize("kind", ["gray8", "rgb", "rgba", "depth16"])
def test_cv2_written_files_decode_exactly(tmp_path, kind, filter_type):
    img = image(kind, 641, height=9, seed=2)
    path = str(tmp_path / "a.png")
    assert cv2.imwrite(path, to_cv2(img), [cv2.IMWRITE_PNG_FILTER, CV2_FILTERS[filter_type]])
    with open(path, "rb") as f:
        data = f.read()
    assert set(row_filters(data).tolist()) == {filter_type}
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    got = png.read_png(path)
    assert got.dtype == want.dtype and np.array_equal(to_cv2(got), want)


@pytest.mark.parametrize("kind", ["gray8", "rgb", "rgba", "depth16"])
def test_port_files_decode_in_cv2(tmp_path, kind):
    img = image(kind, 641, height=9, seed=3)
    path = str(tmp_path / "a.png")
    if kind in ("rgb", "depth16"):
        png.write_png(path, img)
    else:
        with open(path, "wb") as f:
            f.write(encode_any(img))
    got = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert got.dtype == img.dtype and np.array_equal(got, to_cv2(img))


def _with_ihdr(data: bytes, **fields) -> bytes:
    """data with IHDR fields replaced (CRC recomputed) and, for a palette,
    a PLTE chunk after IHDR."""
    names = ("width", "height", "depth", "color", "compression", "filter", "interlace")
    ihdr = dict(zip(names, struct.unpack(">IIBBBBB", data[16:29])), **fields)
    payload = struct.pack(">IIBBBBB", *(ihdr[n] for n in names))

    def chunk(kind, p):
        return struct.pack(">I", len(p)) + kind + p + struct.pack(">I", zlib.crc32(kind + p))

    extra = chunk(b"PLTE", bytes(range(48))) if ihdr["color"] == 3 else b""
    return data[:8] + chunk(b"IHDR", payload) + extra + data[33:]


def test_unsupported_and_corrupt_files_raise(tmp_path):
    gray = encode_any(image("gray8", 16))
    for kind in ("gray8", "gray_alpha", "rgba"):
        with pytest.raises(ValueError, match="cannot encode"):
            png.encode(image(kind, 4))
    bad_crc = bytearray(gray)
    bad_crc[45] ^= 0xFF  # inside the IDAT payload
    with pytest.raises(ValueError, match="CRC"):
        png.decode(bytes(bad_crc))
    with pytest.raises(ValueError, match="palette"):
        png.decode(_with_ihdr(gray, color=3))
    with pytest.raises(ValueError, match="interlace"):
        png.decode(_with_ihdr(gray, interlace=1))
    with pytest.raises(ValueError, match="signature"):
        png.decode(b"GIF89a" + gray[6:])
    path = str(tmp_path / "rgb16.png")
    assert cv2.imwrite(path, np.full((4, 5, 3), 40000, np.uint16))
    with pytest.raises(ValueError, match="16-bit"):
        png.read_png(path)


def test_compare_tool_on_cpu(capsys):
    """`tools/compare_torch_png.py` on the CPU, this tree against itself: 2
    frames at 80x60, one round, one intra-op thread for the render."""
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root / "tools"))
    import compare_torch_png as tool

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert tool.main(["--parent", str(root), "--frames", "2", "--scale", "8", "--device", "cpu",
                          "--rounds", "1"]) == 0
    finally:
        torch.set_num_threads(threads)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["card"] is None and (out["width"], out["height"]) == (80, 60)
    assert all(len(v) == 2 and min(v) > 0 for v in out["ms_per_frame"].values())
