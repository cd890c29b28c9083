"""The port's MILD loop-closure scoring (`lcdetection/mild.py`) against the
JAX package, on the CPU (plain versions).

Inputs: a seeded database of keyframes, each a noisy copy of one of four
"places" (a few to tens of bits flipped per feature) mixed with random
features, and queries made the same way. Tolerances: similarity scores
within 1e-5 relative to the largest (each term is bit-equal; the sums run
in another order); salient scores within 1e-5; candidate indices and their
validity equal. Edge cases the kernel must also meet: g = 0 (every row
skipped) and a keyframe with no valid feature.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from onepiece_tpu.lcdetection import mild as jmild
from onepiece_tpu_torch.lcdetection import mild as tmild

N_CAP, F = 24, 200


def _flip(rng, d, max_bits):
    d = d.copy()
    for row in d.reshape(-1, 8):
        for bit in rng.integers(0, 256, rng.integers(0, max_bits + 1)):
            row[bit // 32] ^= np.uint32(1) << np.uint32(bit % 32)
    return d


@pytest.fixture(scope="module")
def database():
    rng = np.random.default_rng(0)
    places = rng.integers(0, 2**32, (4, F, 8), dtype=np.uint64).astype(np.uint32)
    db = np.stack([_flip(rng, places[i % 4], 40) for i in range(N_CAP)])
    db[:, F // 2 :] = rng.integers(0, 2**32, (N_CAP, F // 2, 8), dtype=np.uint64).astype(np.uint32)
    dbv = rng.random((N_CAP, F)) > 0.1
    queries = [_flip(rng, places[p], 30) for p in (1, 2, 3)]
    qv = rng.random(F) > 0.1
    return db, dbv, queries, qv


def _t(x):
    x = np.asarray(x)
    return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)


def test_feature_scores_and_similarity_match_jax(database):
    db, dbv, queries, qv = database
    for q in queries:
        sj = np.asarray(jmild._similarity_scores(q, qv, db, dbv, num_keyframes=jnp.int32(20)))
        st = tmild._similarity_scores(_t(q), _t(qv), _t(db), _t(dbv), num_keyframes=20).numpy()
        assert sj.max() > 0.1
        assert np.abs(st - sj).max() <= 1e-5 * np.abs(sj).max()
        sj = np.asarray(jmild._similarity_scores(q, qv, db, dbv))
        st = tmild._similarity_scores(_t(q), _t(qv), _t(db), _t(dbv)).numpy()
        assert np.abs(st - sj).max() <= 1e-5 * np.abs(sj).max()


def test_feature_scores_skip_rows_past_g(database):
    db, dbv, queries, qv = database
    g = torch.tensor(9)
    fs = tmild.mild_feature_scores(_t(queries[0]), _t(qv), _t(db), _t(dbv), g)
    assert fs.shape == (F, N_CAP) and bool((fs[:, 9:] == 0).all()) and float(fs[:, :9].max()) > 0
    assert bool((fs[~_t(qv)] == 0).all())
    rows = torch.arange(N_CAP) < g
    full = tmild.mild_feature_scores(_t(queries[0]), _t(qv), _t(db), _t(dbv) & rows[:, None], N_CAP)
    assert torch.equal(fs, full)


@pytest.mark.parametrize("g,limit,exclude", [(24, 23, -1), (20, 19, 3), (13, 13, -1), (9, 8, 5), (3, 3, -1),
                                             (0, 0, -1)])
def test_lc_candidates_device_matches_jax(database, g, limit, exclude):
    db, dbv, queries, qv = database
    for q in queries:
        cj, okj = jmild.lc_candidates_device(q, qv, db, dbv, jnp.int32(g), jnp.int32(limit), jnp.int32(exclude))
        ct, okt = tmild.lc_candidates_device(_t(q), _t(qv), _t(db), _t(dbv), torch.tensor(g),
                                             torch.tensor(limit), torch.tensor(exclude))
        assert np.array_equal(ct.numpy(), np.asarray(cj)) and np.array_equal(okt.numpy(), np.asarray(okj))


@pytest.mark.parametrize("g", [7, 24])
def test_keyframe_with_no_valid_feature_matches_jax(database, g):
    """Keyframe 5 holds no valid feature: its feature scores are 0, and the
    similarity scores and candidates stay the JAX package's."""
    db, dbv, queries, qv = database
    dbv = dbv.copy()
    dbv[5] = False
    for q in queries:
        sj = np.asarray(jmild._similarity_scores(q, qv, db, dbv, num_keyframes=jnp.int32(g)))
        st = tmild._similarity_scores(_t(q), _t(qv), _t(db), _t(dbv), num_keyframes=g).numpy()
        assert sj[5] == 0 and np.abs(st - sj).max() <= 1e-5 * np.abs(sj).max()
        fs = tmild.mild_feature_scores(_t(q), _t(qv), _t(db), _t(dbv), torch.tensor(g))
        assert bool((fs[:, 5] == 0).all()) and float(fs[:, :g].max()) > 0
        cj, okj = jmild.lc_candidates_device(q, qv, db, dbv, jnp.int32(g), jnp.int32(g - 1), jnp.int32(-1))
        ct, okt = tmild.lc_candidates_device(_t(q), _t(qv), _t(db), _t(dbv), torch.tensor(g),
                                             torch.tensor(g - 1), torch.tensor(-1))
        assert np.array_equal(ct.numpy(), np.asarray(cj)) and np.array_equal(okt.numpy(), np.asarray(okj))


def test_salient_scores_device_matches_jax():
    rng = np.random.default_rng(4)
    for g in (0, 1, 2, 5, 12, 16):
        sims = rng.random(16).astype(np.float32)
        sims[g // 2 :] += 1.0  # a trailing above-average streak
        sj = np.asarray(jmild.salient_scores_device(jnp.asarray(sims), jnp.int32(g)))
        st = tmild.salient_scores_device(torch.from_numpy(sims), torch.tensor(g)).numpy()
        assert np.abs(st - sj).max() <= 1e-5
