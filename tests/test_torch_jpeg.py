"""The port's JPEG decoder (`io/jpeg.py` over `native/jpeg_decode.cpp`), PGM
reader (`io/pgm.py`) and bilinear remap (`io/scannet.remap_linear` over
`native/remap.cpp`) against OpenCV, which the JAX package reads ScanNet
with.

- JPEGs written by cv2 into memory decode bit-equal to `cv2.imdecode`
  (BGR flipped to RGB): sizes 97x75 and 162x121 (no multiple of the MCU),
  samplings 4:4:4 / 4:2:2 / 4:2:0, qualities 50 / 90 / 100, restart
  intervals and optimised Huffman tables at every sampling, gray, and
  images of 1 to 33 pixels (libjpeg's box upsampling below three chroma
  columns). Tolerance: none (libjpeg-turbo's decode is integer arithmetic
  throughout).
- Extended sequential, progressive, arithmetic-coded, lossless and 12-bit
  streams, truncated and corrupt ones, and Huffman tables whose code
  lengths no prefix code has raise `ValueError`; `read_jpeg` names the
  file; a failed native build raises.
- PGMs written by hand (8-bit, 16-bit, a comment, a maxval below the
  samples) read as `cv2.imread(..., IMREAD_UNCHANGED)` reads them; other
  PNM kinds and short files raise.
- The remap equals `cv2.remap(INTER_LINEAR)` with its constant border 0 on
  random colour images at random maps reaching past every edge, and at
  ScanNet's own intrinsics (depth pixel u = 0 lands near colour u = -6);
  other channel counts raise.
- The committed fixture `tests/data/scannet_synth/` matches its manifest
  through cv2 and through the port.
"""

import json
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from onepiece_tpu_torch import _native
from onepiece_tpu_torch.io import jpeg, pgm, scannet

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "data" / "scannet_synth"
sys.path.insert(0, str(REPO / "tools"))
import torch_make_scannet_fixture as fixture_tool  # noqa: E402

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}
SIZES = [(75, 97), (121, 162)]  # (H, W)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Smooth colour waves, sharp steps and noise (BGR, uint8)."""
    rng = np.random.default_rng(seed)
    v, u = np.mgrid[:h, :w].astype(np.float64)
    base = np.stack([np.sin(u / 7.0) * 80 + 120, np.cos(v / 5.0) * 90 + 120, ((u // 9 + v // 7) % 2) * 150 + 50], -1)
    return np.clip(base + rng.normal(0, 20, base.shape), 0, 255).astype(np.uint8)


def _encode(img: np.ndarray, *params) -> bytes:
    ok, enc = cv2.imencode(".jpg", img, list(params))
    assert ok
    return enc.tobytes()


def _cv2_rgb(data: bytes) -> np.ndarray:
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("quality", [50, 90, 100])
def test_decode_matches_cv2(size, sampling, quality):
    data = _encode(_image(*size), cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   SAMPLING[sampling])
    out = jpeg.decode(data)
    assert out.dtype == np.uint8 and out.shape == size + (3,)
    np.testing.assert_array_equal(out, _cv2_rgb(data))


@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("option", ["restart", "optimize"])
def test_restart_intervals_and_optimised_tables(sampling, option):
    extra = [cv2.IMWRITE_JPEG_RST_INTERVAL, 3] if option == "restart" else [cv2.IMWRITE_JPEG_OPTIMIZE, 1]
    data = _encode(_image(121, 162, seed=1), cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   SAMPLING[sampling], *extra)
    marker = b"\xff\xdd" if option == "restart" else None
    if marker:
        assert marker in data and b"\xff\xd0" in data  # DRI and RST0 are in the stream
    np.testing.assert_array_equal(jpeg.decode(data), _cv2_rgb(data))


@pytest.mark.parametrize("size", SIZES)
def test_gray(size):
    data = _encode(_image(*size)[..., 1], cv2.IMWRITE_JPEG_QUALITY, 90)
    out = jpeg.decode(data)
    assert out.shape == size
    np.testing.assert_array_equal(out, cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("size", [(1, 1), (2, 3), (8, 8), (17, 33)])
def test_tiny_images(size):
    data = _encode(_image(*size, seed=2), cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["420"])
    np.testing.assert_array_equal(jpeg.decode(data), _cv2_rgb(data))


def _patched_sof(data: bytes, marker: int, precision: int = 8) -> bytes:
    at = data.index(b"\xff\xc0")
    return data[:at + 1] + bytes([marker]) + data[at + 2:at + 4] + bytes([precision]) + data[at + 5:]


@pytest.mark.parametrize("kind", ["extended", "progressive", "arithmetic", "lossless", "12-bit", "truncated", "corrupt",
                                  "no image"])
def test_unsupported_and_broken_streams_raise(kind):
    img = _image(75, 97)
    base = _encode(img, cv2.IMWRITE_JPEG_QUALITY, 90)
    data, match = {
        "extended": (_patched_sof(base, 0xC1), "extended sequential"),
        "progressive": (_encode(img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1), "progressive"),
        "arithmetic": (_patched_sof(base, 0xC9), "arithmetic"),
        "lossless": (_patched_sof(base, 0xC3), "lossless"),
        "12-bit": (_patched_sof(base, 0xC0, precision=12), "12-bit"),
        "truncated": (base[: len(base) // 2], "truncated"),
        "corrupt": (base[: len(base) // 2] + b"\xff\xd9", "truncated or corrupt"),
        "no image": (b"\xff\xd8\xff\xd9", "without image data"),
    }[kind]
    with pytest.raises(ValueError, match=match):
        jpeg.decode(data)


def _with_dht(data: bytes, counts: list[int]) -> bytes:
    """`data` with its first DHT segment replaced by one well-framed table of
    these code-length counts (symbols 0, 1, ... mod 12, valid as DC or AC)."""
    at = data.index(b"\xff\xc4")
    end = at + 2 + int.from_bytes(data[at + 2:at + 4], "big")
    counts = counts + [0] * (16 - len(counts))
    body = bytes([data[at + 4]]) + bytes(counts) + bytes(i % 12 for i in range(sum(counts)))
    return data[:at] + b"\xff\xc4" + (len(body) + 2).to_bytes(2, "big") + body + data[end:]


@pytest.mark.parametrize("counts", [[3], [2, 1], [1, 2], [0, 0, 8], [255]],
                         ids=["3 of length 1", "2 of 1 then 1 of 2", "all-ones code", "all-ones at length 3",
                              "255 of length 1"])
def test_corrupt_huffman_tables_raise(counts):
    """Code-length counts that no prefix code has (or that need the all-ones
    code, which libjpeg rejects too) raise before any table is written."""
    data = _with_dht(_encode(_image(75, 97), cv2.IMWRITE_JPEG_QUALITY, 90), counts)
    with pytest.raises(ValueError, match="bad Huffman table"):
        jpeg.decode(data)
    assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is None


def test_mutated_streams_decode_or_raise():
    """Random bytes written over the headers (bar the frame's size) or the
    scan of streams of each sampling (restart intervals, optimised tables,
    gray), some then cut: each decodes or raises `ValueError`, and none
    takes the process down. (With the decoder built with
    -fsanitize=address, such streams show no bad access, and they find the
    Huffman overrun that `test_corrupt_huffman_tables_raise` pins.)"""
    rng = np.random.default_rng(11)
    img = _image(45, 61, seed=3)
    bases = [_encode(img, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[s], *extra) for s in SAMPLING
             for extra in ([cv2.IMWRITE_JPEG_RST_INTERVAL, 2], [cv2.IMWRITE_JPEG_OPTIMIZE, 1])]
    bases.append(_encode(img[..., 0]))
    raised = 0
    for it in range(3000):
        data = bytearray(bases[it % len(bases)])
        scan, size = data.index(b"\xff\xda") + 20, data.index(b"\xff\xc0") + 5
        for _ in range(rng.integers(1, 5)):
            at = rng.integers(2, scan) if rng.random() < 0.5 else rng.integers(2, len(data))
            if not size <= at < size + 4:  # the frame's height and width stay: no huge image is asked for
                data[at] = rng.integers(0, 256)
        if rng.random() < 0.2:
            data = data[:rng.integers(2, len(data))]
        try:
            out = jpeg.decode(bytes(data))
        except ValueError:
            raised += 1
        else:
            assert out.dtype == np.uint8 and out.ndim in (2, 3)
    assert 0 < raised < 3000


def test_truncation_anywhere_raises():
    """Every cut of a stream, in its headers or its scan, raises."""
    data = _encode(_image(75, 97), cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, 2)
    for cut in range(1, len(data) - 1, 97):
        with pytest.raises(ValueError):
            jpeg.decode(data[:cut])


def test_read_jpeg_names_the_file(tmp_path):
    path = tmp_path / "frame-000000.color.jpg"
    path.write_bytes(b"not a jpeg")
    with pytest.raises(ValueError, match="frame-000000.color.jpg: not a JPEG file"):
        jpeg.read_jpeg(str(path))


def test_jpeg_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "jpeg_decode.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_native, "JPEG_SOURCE", bad)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on jpeg_decode.cpp"):
        jpeg.decode(b"\xff\xd8")
    assert not list((tmp_path / "build").glob("*.so"))


def _pgm(path, w, h, maxval, samples: np.ndarray, header_tail=b"") -> None:
    dtype = np.uint8 if maxval <= 255 else ">u2"
    path.write_bytes(b"P5\n" + header_tail + f"{w} {h}\n{maxval}\n".encode() + samples.astype(dtype).tobytes())


@pytest.mark.parametrize("case", ["8-bit", "16-bit", "comment", "maxval 1000"])
def test_pgm_matches_cv2(tmp_path, case):
    rng = np.random.default_rng(3)
    path = tmp_path / "d.pgm"
    if case == "8-bit":
        _pgm(path, 13, 7, 255, rng.integers(0, 256, (7, 13)))
    elif case == "16-bit":
        _pgm(path, 13, 7, 65535, rng.integers(0, 65536, (7, 13)))
    elif case == "comment":
        _pgm(path, 13, 7, 65535, rng.integers(0, 65536, (7, 13)), header_tail=b"# written by a test\n")
    else:  # samples above maxval come back unscaled, as cv2 returns them
        _pgm(path, 13, 7, 1000, rng.integers(0, 4000, (7, 13)))
    ref = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    out = pgm.read_pgm(str(path))
    assert out.dtype == ref.dtype and out.dtype.isnative
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("data,match", [
    (b"P2\n2 1\n255\n1 2\n", "P5"),
    (b"P6\n2 1\n255\n" + bytes(6), "P5"),
    (b"P5\n4 4\n65535\n" + bytes(10), "truncated PGM data"),
    (b"P5\n4 x\n255\n", "header field"),
])
def test_pgm_rejects(tmp_path, data, match):
    path = tmp_path / "bad.pgm"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=match):
        pgm.read_pgm(str(path))


@pytest.mark.parametrize("seed", [4, 6])
def test_remap_matches_cv2_past_every_edge(seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (121, 162, 3), dtype=np.uint8)
    for _ in range(4):
        mu = rng.uniform(-3.0, 165.0, (60, 80)).astype(np.float32)
        mv = rng.uniform(-3.0, 124.0, (60, 80)).astype(np.float32)
        mu[:, :5] = np.float32(3.5)  # exact halves: the rounding of ties
        np.testing.assert_array_equal(scannet.remap_linear(img, mu, mv), cv2.remap(img, mu, mv, cv2.INTER_LINEAR))


@pytest.mark.parametrize("shape", [(121, 162), (121, 162, 1), (121, 162, 4)])
def test_remap_takes_only_colour(shape):
    mu = np.zeros((6, 8), np.float32)
    with pytest.raises(ValueError, match="needs an \\(H, W, 3\\) image"):
        scannet.remap_linear(np.zeros(shape, np.uint8), mu, mu)


def test_remap_at_scannet_intrinsics():
    img = _image(968, 1296, seed=5)
    mu, mv = scannet.depth_grid_map(fixture_tool.COLOR_CAMERA, fixture_tool.DEPTH_CAMERA)
    assert mu[0, 0] < -6.0 and mu[0, -1] > 1295.0  # the border columns fall outside the colour image
    np.testing.assert_array_equal(scannet.remap_linear(img, mu, mv), cv2.remap(img, mu, mv, cv2.INTER_LINEAR))
    with pytest.raises(ValueError, match="finite"):
        scannet.remap_linear(img, np.full_like(mu, np.nan), mv)


def test_fixture_matches_its_manifest():
    """The committed JPEGs decode, in cv2 and in the port, to the manifest's
    hashes, and both remaps onto the depth grid to its remap hashes."""
    manifest = json.loads((FIXTURE / "manifest.json").read_text())
    assert len(manifest["frames"]) == fixture_tool.FRAMES
    np.testing.assert_array_equal(np.asarray(manifest["poses"], np.float32),
                                  fixture_tool.synthetic.orbit_trajectory(fixture_tool.FRAMES))
    mu, mv = scannet.depth_grid_map(fixture_tool.COLOR_CAMERA, fixture_tool.DEPTH_CAMERA)
    for f in manifest["frames"]:
        data = (FIXTURE / f["file"]).read_bytes()
        assert len(data) == f["bytes"] and data[:2] == b"\xff\xd8"
        ref, port = _cv2_rgb(data), jpeg.decode(data)
        assert fixture_tool.sha256(ref) == fixture_tool.sha256(port) == f["decode_sha256"]
        aligned = scannet.align_color_to_depth(port, fixture_tool.COLOR_CAMERA, fixture_tool.DEPTH_CAMERA)
        assert aligned.shape == (480, 640, 3)
        assert fixture_tool.sha256(cv2.remap(ref, mu, mv, cv2.INTER_LINEAR)) == f["remap_sha256"]
        assert fixture_tool.sha256(aligned) == f["remap_sha256"]

