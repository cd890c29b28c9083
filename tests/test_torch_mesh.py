"""The port's `geometry/mesh.TriangleMesh` and its native library against
the JAX package's `TriangleMesh` on the CPU, on `tests/test_mesh.py`'s
icospheres (with seeded noise and colours where stated).

Tolerances: QEM and pruning bit-equal (one C++ source, built with one set
of flags on one machine); vertex normals within 1e-6 (they come out
bit-equal here: the same products, `np.add.at`'s order of sums, a
correctly rounded root); clustering simplification faces equal and
vertices and colours within 1e-6 (float64 sums in `np.add.at`'s order).
Torch is pinned to one intra-op thread while the module runs.
"""

import numpy as np
import pytest
import torch

from onepiece_tpu.geometry.mesh import TriangleMesh as JMesh
from onepiece_tpu_torch import _native
from onepiece_tpu_torch.geometry.mesh import TriangleMesh
from test_mesh import icosphere


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def noisy_sphere(subdiv=3, seed=0, colours=False):
    v, f = icosphere(subdiv)
    rng = np.random.default_rng(seed)
    v = v + rng.normal(0, 0.01, v.shape).astype(np.float32)
    return v, f, (rng.uniform(0, 1, v.shape).astype(np.float32) if colours else None)


def two_components():
    v1, f1 = icosphere(2)  # 320 faces
    v2, f2 = icosphere(0, radius=0.1)  # 20 faces, offset
    return np.concatenate([v1, v2 + 5.0]).astype(np.float32), np.concatenate([f1, f2 + len(v1)])


@pytest.mark.parametrize("noise", [False, True])
def test_vertex_normals(noise):
    v, f, _ = noisy_sphere() if noise else (*icosphere(2), None)
    # an unreferenced vertex keeps a zero normal
    v = np.concatenate([v, [[3.0, 3.0, 3.0]]]).astype(np.float32)
    j = JMesh(v, f).compute_vertex_normals().normals
    t = TriangleMesh.from_numpy(v, f, device="cpu").compute_vertex_normals().normals.numpy()
    np.testing.assert_allclose(t, j, atol=1e-6, rtol=0)
    assert not t[-1].any()


@pytest.mark.parametrize("cell", [0.3, 0.05])
@pytest.mark.parametrize("colours", [False, True])
def test_clustering_simplify(cell, colours):
    v, f, c = noisy_sphere(colours=colours)
    j = JMesh(v, f, c).clustering_simplify(cell)
    t = TriangleMesh.from_numpy(v, f, c, device="cpu").clustering_simplify(cell)
    np.testing.assert_array_equal(t.faces.numpy(), j.faces)
    np.testing.assert_allclose(t.vertices.numpy(), j.vertices, atol=1e-6, rtol=0)
    if colours:
        np.testing.assert_allclose(t.colors.numpy(), j.colors, atol=1e-6, rtol=0)
    else:
        assert t.colors is None and j.colors is None


@pytest.mark.parametrize("target", [300, 1000, 5000])
@pytest.mark.parametrize("noise", [False, True])
def test_quadric_simplify_bit_equal(target, noise):
    v, f, _ = noisy_sphere() if noise else (*icosphere(3), None)
    j = JMesh(v, f).quadric_simplify(target)
    t = TriangleMesh.from_numpy(v, f, device="cpu").quadric_simplify(target)
    assert t.vertices.dtype == torch.float32 and t.faces.dtype == torch.int64
    np.testing.assert_array_equal(t.vertices.numpy(), j.vertices)
    np.testing.assert_array_equal(t.faces.numpy(), j.faces)


@pytest.mark.parametrize("min_faces", [10, 100, 1000])
def test_prune_bit_equal(min_faces):
    v, f = two_components()
    n = np.random.default_rng(1).normal(0, 1, v.shape).astype(np.float32)
    j = JMesh(v, f, normals=n).prune(min_faces)
    t = TriangleMesh.from_numpy(v, f, normals=n, device="cpu").prune(min_faces)
    np.testing.assert_array_equal(t.vertices.numpy(), j.vertices)
    np.testing.assert_array_equal(t.faces.numpy(), j.faces)
    np.testing.assert_array_equal(t.normals.numpy(), j.normals)


def test_compact_and_ply_round_trip(tmp_path):
    v, f, c = noisy_sphere(2, colours=True)
    v = np.concatenate([v, np.ones((2, 3), np.float32)])  # two unreferenced vertices
    c = np.concatenate([c, np.zeros((2, 3), np.float32)])
    j = JMesh(v, f, c).compact()
    t = TriangleMesh.from_numpy(v, f, c, device="cpu").compact()
    for a, b in zip(t.numpy()[:3], (j.vertices, j.faces, j.colors)):
        np.testing.assert_array_equal(a, b)
    path = str(tmp_path / "m.ply")
    t.compute_vertex_normals().write_ply(path)
    back = TriangleMesh.read_ply(path, device="cpu")
    jback = JMesh.read_ply(path)
    np.testing.assert_array_equal(back.vertices.numpy(), jback.vertices)
    np.testing.assert_array_equal(back.faces.numpy(), jback.faces)
    np.testing.assert_array_equal(back.normals.numpy(), t.normals.numpy())
    np.testing.assert_allclose(back.colors.numpy(), t.colors.numpy(), atol=1 / 255)


def test_native_library_builds_from_the_ports_copy():
    path = _native.build(_native.MESH_SOURCE)
    assert path.parent == _native.BUILD_DIR and path.exists()
    assert _native.MESH_SOURCE.parent.parent.name == "onepiece_tpu_torch"
    src = _native.MESH_SOURCE.read_text()
    jax_src = (_native.PACKAGE_DIR.parent / "onepiece_tpu" / "native" / "mesh_native.cpp").read_text()
    # the same algorithms below the port's note
    assert src.split("#include", 1)[1] == jax_src.split("#include", 1)[1]


def test_native_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "mesh_native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_native, "MESH_SOURCE", bad)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        _native.mesh_library()
    assert not list((tmp_path / "build").glob("*.so"))


def test_read_ply_faces_triangles_and_polygons(tmp_path):
    """A binary face list of triangles only is read as one array; one with a
    quad among them falls back to the face-by-face read (its first three
    indices), as the JAX reader reads both."""
    from onepiece_tpu.io.ply import read_ply as jread
    from onepiece_tpu_torch.io.ply import read_ply

    v, f = icosphere(1)
    for name, counts in (("tris", [3] * len(f)), ("quad", [3, 4] + [3] * (len(f) - 2))):
        head = (f"ply\nformat binary_little_endian 1.0\nelement vertex {len(v)}\nproperty float x\nproperty float y\n"
                f"property float z\nelement face {len(f)}\nproperty list uchar int vertex_indices\nend_header\n")
        body = b"".join(bytes([n]) + np.asarray([*row, *row[:1]][:n], "<i4").tobytes() for n, row in zip(counts, f))
        path = tmp_path / f"{name}.ply"
        path.write_bytes(head.encode() + v.astype("<f4").tobytes() + body)
        t, j = read_ply(str(path)), jread(str(path))
        np.testing.assert_array_equal(t["faces"], j["faces"])
        np.testing.assert_array_equal(t["faces"], f)
        assert t["faces"].dtype == np.int64
