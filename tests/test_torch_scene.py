"""Scene analysis in the port against the JAX package on the CPU:
`algorithm/clustering.py`, `algorithm/patch_detection.py`,
`algorithm/dcel.py` and `algorithm/rooms.py`.

Tolerances:
- k-means, k-medoids and mean shift fed the JAX package's initial indices
  (its Gumbel top-k of the same PRNG key): labels and medoids equal,
  centres and modes within 1e-5 (float32 sums in another order).
- `local_models`: normals within 1e-9 up to sign, rms within 1e-9, at every
  point whose fit is determined. A fit whose kept neighbours are two points
  (or collinear) has a repeated smallest eigenvalue: its normal is any
  vector across their line, and numpy's LAPACK, the port's and cuSOLVER
  each pick another. Such points are counted and are under 1 % here.
- `detect_patches`: equal member sets and models on
  `tests/test_algorithm.py:47`'s two planes. On a seeded three-plane corner
  a few edge points have such undetermined fits, and their rms (near 0)
  makes them the first seeds, so which plane grows first, and takes the
  shared edge's points, is each LAPACK's choice: there the patches' count
  and normals (1e-3) are held end to end, and the region growing is held
  equal (member sets and models) fed the JAX package's local fits.
- `build_arrangement`, `face_adjacency` and `edge_wall_evidence`: equal
  (the same numpy code on the same input).
- `diffusion_embedding`: its rows' Gram matrix within 1e-5 (eigenvectors
  are defined up to sign); `detect_rooms` fed the JAX package's initial
  faces: labels equal up to a permutation.

Torch is pinned to one intra-op thread while the module runs.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepiece_tpu.algorithm import clustering as jclust
from onepiece_tpu.algorithm import dcel as jdcel
from onepiece_tpu.algorithm import patch_detection as jpatch
from onepiece_tpu.algorithm import rooms as jrooms
from onepiece_tpu.ops.knn import knn as jknn
from onepiece_tpu_torch.algorithm import clustering as tclust
from onepiece_tpu_torch.algorithm import dcel as tdcel
from onepiece_tpu_torch.algorithm import patch_detection as tpatch
from onepiece_tpu_torch.algorithm import rooms as trooms

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import torch_room_detection  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_init(seed: int, valid: np.ndarray, k: int) -> torch.Tensor:
    """The JAX package's initial indices for PRNGKey(seed): the top k of its
    Gumbel draw over the valid points."""
    g = jax.random.gumbel(jax.random.PRNGKey(seed), (len(valid),))
    _, idx = jax.lax.top_k(jnp.where(jnp.asarray(valid), 0.0, -jnp.inf) + g, k)
    return torch.from_numpy(np.array(idx))


def blobs(n=60, seed=31):
    rng = np.random.default_rng(seed)
    centers = np.array([[0.0, 0.0], [5.0, 0.0], [0.0, 5.0]])
    return np.concatenate([c + rng.normal(0, 0.3, (n, 2)) for c in centers]).astype(np.float32)


@pytest.mark.parametrize("some_invalid", [False, True])
def test_kmeans_fed_jax_init(some_invalid):
    pts = blobs()
    valid = np.ones(len(pts), bool)
    if some_invalid:
        valid[::7] = False
    jc, jl = jclust.kmeans(jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(valid), k=3)
    tc, tl = tclust.kmeans(None, torch.from_numpy(pts), torch.from_numpy(valid), 3, init=jax_init(0, valid, 3))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5, rtol=0)


@pytest.mark.parametrize("some_invalid", [False, True])
def test_kmedoids_fed_jax_init(some_invalid):
    pts = blobs()
    valid = np.ones(len(pts), bool)
    if some_invalid:
        valid[::5] = False
    jm, jl = jclust.kmedoids(jax.random.PRNGKey(1), jnp.asarray(pts), jnp.asarray(valid), k=3)
    tm, tl = tclust.kmedoids(None, torch.from_numpy(pts), torch.from_numpy(valid), 3, init=jax_init(1, valid, 3))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_mean_shift():
    pts = blobs(40)
    valid = np.ones(len(pts), bool)
    valid[3] = False
    jm = jclust.mean_shift(jnp.asarray(pts), jnp.asarray(valid), 1.0)
    tm = tclust.mean_shift(torch.from_numpy(pts), torch.from_numpy(valid), 1.0)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5, rtol=0)
    jc, jl = jclust.mean_shift_clusters(jnp.asarray(pts), jnp.asarray(valid), bandwidth=1.0)
    tc, tl = tclust.mean_shift_clusters(torch.from_numpy(pts), torch.from_numpy(valid), bandwidth=1.0)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(tc, jc, atol=1e-5, rtol=0)
    assert len(tc) == 3 and tl[3] == -1


def test_generator_draws_distinct_valid_starts():
    pts = torch.from_numpy(blobs())
    valid = torch.ones(len(pts), dtype=torch.bool)
    valid[:100] = False
    idx = tclust._initial_indices(torch.Generator().manual_seed(3), valid, 5, None)
    assert len(set(idx.tolist())) == 5 and bool(valid[idx].all())
    a = tclust.kmeans(torch.Generator().manual_seed(3), pts, valid, 3)
    b = tclust.kmeans(torch.Generator().manual_seed(3), pts, valid, 3)
    assert torch.equal(a[1], b[1]) and bool((a[1][:100] == -1).all())
    with pytest.raises(ValueError):
        tclust.kmeans(None, pts, valid, 3)


# -- patch detection ---------------------------------------------------------


def two_planes(seed=31):
    """tests/test_algorithm.py:47's construction: z = 0 and y = 0, 150 points each."""
    rng = np.random.default_rng(seed)
    a = np.c_[rng.uniform(-1, 1, (150, 2)), np.zeros(150)]
    b = np.c_[rng.uniform(-1, 1, (150, 1)), np.zeros(150), rng.uniform(0.1, 1.5, (150, 1))]
    return np.concatenate([a, b]).astype(np.float32)


def corner(seed=0):
    """tools/detect_plane.py's synthetic corner: three perpendicular planes
    of 500 points, 3 mm noise."""
    rng = np.random.default_rng(seed)
    a = np.c_[rng.uniform(0, 2, (500, 2)), np.zeros(500)]
    b = np.c_[rng.uniform(0, 2, 500), np.zeros(500), rng.uniform(0, 2, 500)]
    c = np.c_[np.zeros(500), rng.uniform(0, 2, (500, 2))]
    pts = np.concatenate([a, b, c]).astype(np.float32)
    return pts + rng.normal(0, 0.003, pts.shape).astype(np.float32)


def neighbours(pts, k):
    idx, _ = jknn(jnp.asarray(pts), jnp.asarray(pts), jnp.ones(len(pts), bool), k=k)
    return np.asarray(idx)


def determined(pts, nbrs, thr, rounds=2):
    """Whether each point's local fits (the JAX package's rounds) have a
    simple smallest eigenvalue in every round: its normal is then defined."""
    nb = pts.astype(np.float64)[nbrs]
    w = np.ones(nb.shape[:2])
    gap = np.full(len(pts), np.inf)
    for _ in range(rounds + 1):
        cnt = np.maximum(w.sum(1), 1.0)
        mu = (nb * w[..., None]).sum(1) / cnt[:, None]
        X = (nb - mu[:, None]) * w[..., None]
        ev, vec = np.linalg.eigh(np.einsum("nki,nkj->nij", X, X) / cnt[:, None, None])
        gap = np.minimum(gap, (ev[:, 1] - ev[:, 0]) / np.maximum(ev[:, -1], 1e-300))
        n = vec[..., 0]
        dist = np.abs(np.einsum("nkd,nd->nk", nb, n) - np.einsum("ni,ni->n", n, mu)[:, None])
        w = (dist <= thr).astype(np.float64)
    return gap > 1e-9


@pytest.mark.parametrize("case", ["two planes", "corner", "2-D walls"])
def test_local_models_up_to_sign(case):
    if case == "two planes":
        pts, k, thr = two_planes(), 10, 0.03
    elif case == "corner":
        pts, k, thr = corner(), 10, 0.02
    else:
        pts, k, thr = torch_room_detection.two_room_plan(np.random.default_rng(0))[:600], 8, 0.05
    nbrs = neighbours(pts, k)
    jn, jr = jpatch.local_models(pts.astype(np.float64), nbrs, thr)
    tn, tr = (x.numpy() for x in tpatch.local_models(torch.from_numpy(pts), torch.from_numpy(nbrs), thr))
    ok = determined(pts, nbrs, thr)
    assert (~ok).sum() <= 0.01 * len(pts), (~ok).sum()
    err = np.minimum(np.abs(tn - jn).max(1), np.abs(tn + jn).max(1))
    assert err[ok].max() <= 1e-9
    assert np.abs(tr - jr)[ok].max() <= 1e-9


def _same_patches(jp, tp):
    assert len(tp) == len(jp)
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(b.indices, a.indices)
        np.testing.assert_allclose(b.model, a.model, atol=1e-9, rtol=0)


def test_detect_patches_two_planes():
    pts = two_planes()
    nbrs = neighbours(pts, 10)
    jp = jpatch.detect_patches(pts, nbrs, residual_threshold=0.03, min_points=50)
    tp = tpatch.detect_patches(torch.from_numpy(pts), torch.from_numpy(nbrs), residual_threshold=0.03, min_points=50)
    assert len(jp) == 2
    _same_patches(jp, tp)


@pytest.mark.parametrize("case", ["corner", "2-D walls"])
def test_region_growing_fed_jax_local_fits(case, monkeypatch):
    if case == "corner":
        pts, k, kw = corner(), 10, dict(residual_threshold=0.02, min_points=50)
    else:
        pts, k, kw = torch_room_detection.two_room_plan(np.random.default_rng(0)), 8, \
            dict(residual_threshold=0.05, min_points=40)
    nbrs = neighbours(pts, k)
    jp = jpatch.detect_patches(pts, nbrs, **kw)
    jn, jr = jpatch.local_models(pts.astype(np.float64), nbrs, kw["residual_threshold"])
    monkeypatch.setattr(tpatch, "local_models", lambda *a: (torch.from_numpy(jn), torch.from_numpy(jr)))
    tp = tpatch.detect_patches(torch.from_numpy(pts), torch.from_numpy(nbrs), **kw)
    assert len(jp) >= 3
    _same_patches(jp, tp)


def test_detect_patches_corner_end_to_end():
    pts = corner()
    nbrs = neighbours(pts, 10)
    jp = jpatch.detect_patches(pts, nbrs, residual_threshold=0.02, min_points=50)
    tp = tpatch.detect_patches(torch.from_numpy(pts), torch.from_numpy(nbrs), residual_threshold=0.02, min_points=50)
    assert len(tp) == len(jp) == 3

    def normals(ps):
        return sorted((tuple(np.round(np.abs(p.model[:3]), 3)) for p in ps))

    np.testing.assert_allclose(normals(tp), normals(jp), atol=1e-3)
    assert sum(len(p.indices) for p in tp) >= 0.9 * len(pts)


# -- arrangements and rooms -----------------------------------------------------


def _plan_lines():
    """The wall lines the JAX package detects on tools/room_detection.py's plan."""
    rng = np.random.default_rng(0)
    wall = torch_room_detection.two_room_plan(rng)
    sub = wall[rng.choice(len(wall), min(len(wall), 1500), replace=False)]
    patches = jpatch.detect_patches(sub, neighbours(sub, 8), residual_threshold=0.05, min_points=40)
    lo, hi = wall.min(0) - 0.2, wall.max(0) + 0.2
    return wall, np.asarray([p.model[:4] for p in patches], float), tuple(lo), tuple(hi)


ARRANGEMENTS = {
    "grid": lambda: (None, np.array([[0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]]), (-1, -1), (1, 1)),
    "divider": lambda: (np.c_[np.zeros(100), np.linspace(-1, 1, 100)], np.array([[0.0, 0.0, 0.0, 1.0]]),
                        (-2, -1), (2, 1)),
    "two-room plan": _plan_lines,
}


@pytest.mark.parametrize("case", list(ARRANGEMENTS))
def test_arrangement_and_wall_evidence_equal(case):
    wall, lines, lo, hi = ARRANGEMENTS[case]()
    ja = jdcel.build_arrangement(lines, box_lo=lo, box_hi=hi)
    ta = tdcel.build_arrangement(lines, box_lo=lo, box_hi=hi)
    for f in ("vertices", "edges", "edge_line"):
        np.testing.assert_array_equal(getattr(ta, f), getattr(ja, f))
    assert ta.faces == ja.faces and ta.face_edges == ja.face_edges
    assert tdcel.face_adjacency(ta) == jdcel.face_adjacency(ja)
    np.testing.assert_array_equal(tdcel.face_centroids(ta), jdcel.face_centroids(ja))
    if wall is not None:
        np.testing.assert_array_equal(trooms.edge_wall_evidence(ta, wall), jrooms.edge_wall_evidence(ja, wall))


def _same_up_to_permutation(a, b):
    pairs = set(zip(a.tolist(), b.tolist()))
    assert len(pairs) == len(set(a.tolist())) == len(set(b.tolist())), pairs


@pytest.mark.parametrize("case", ["divider", "two-room plan"])
def test_detect_rooms_fed_jax_init(case):
    wall, lines, lo, hi = ARRANGEMENTS[case]()
    arr = jdcel.build_arrangement(lines, box_lo=lo, box_hi=hi)
    jl = jrooms.detect_rooms(arr, wall, num_rooms=2)
    nf = len(arr.faces)
    tl = trooms.detect_rooms(arr, wall, num_rooms=2, device="cpu", init=jax_init(0, np.ones(nf, bool), 2))
    _same_up_to_permutation(tl, np.asarray(jl))
    if case == "divider":
        assert tl[0] != tl[1]


def test_diffusion_embedding_gram():
    wall, lines, lo, hi = _plan_lines()
    arr = jdcel.build_arrangement(lines, box_lo=lo, box_hi=hi)
    nf = len(arr.faces)
    ev = jrooms.edge_wall_evidence(arr, wall)
    aff = np.eye(nf)
    for fa, fb, e in jdcel.face_adjacency(arr):
        aff[fa, fb] = aff[fb, fa] = np.exp(-4.0 * ev[e])
    je = np.asarray(jrooms.diffusion_embedding(aff, dim=8))
    te = trooms.diffusion_embedding(torch.from_numpy(aff), dim=8).numpy()
    np.testing.assert_allclose(te @ te.T, je @ je.T, atol=1e-5, rtol=0)
