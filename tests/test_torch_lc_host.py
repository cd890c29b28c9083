"""The port's MILD host half (`lcdetection/mild.py`: `salient_scores`,
`BayesianTemporalFilter`, `LoopClosureDetector`) against the JAX package's,
on the CPU (plain versions).

Tolerances: salient scores bit-equal (the same numpy); filter
probabilities within 1e-6 and its flags equal after every step; the
detector's similarity scores within 1e-5 relative (the port sums each
feature's terms in another order than the JAX package's one distance
table) and its candidate lists equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepiece_tpu.lcdetection import mild as jmild
from onepiece_tpu_torch.lcdetection import mild as tmild


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while the module runs (the test workers share the
    host's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand_desc(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint32)


def _noisy(rng, desc, bits=4):
    """Flip `bits` random bits in each 256-bit descriptor."""
    out = desc.copy()
    for i in range(len(out)):
        for _ in range(bits):
            out[i, rng.integers(0, 8)] ^= np.uint32(1 << int(rng.integers(0, 32)))
    return out


def _t(desc_u32):
    """uint32 descriptor words as the port's int32 words."""
    return torch.from_numpy(np.ascontiguousarray(desc_u32).view(np.int32))


@pytest.mark.parametrize("case", ["random", "all_above_average", "short_history", "flat", "formula", "empty"])
def test_salient_scores_bit_equal(case):
    rng = np.random.default_rng(4)
    sims = {
        "random": rng.gamma(2.0, 0.3, 40).astype(np.float32),
        "all_above_average": np.array([1.0, 1.0, 1.0], np.float32),  # hist <= 0
        "short_history": np.array([1.0, 2.0, 0.5, 3.0], np.float32),  # hist < 3
        "flat": np.zeros(12, np.float32),  # mean < 1e-8
        "formula": np.array([0.1, 0.12, 0.09, 0.11, 0.1, 0.08, 0.5], np.float32),
        "empty": np.zeros(0, np.float32),
    }[case]
    a, b = tmild.salient_scores(sims), jmild.salient_scores(sims)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_bayesian_filter_matches_jax_with_a_retro_erasure():
    """12 steps over a growing database: repeated evidence at keyframe 4
    ramps the visit probability up until it flags once (step 7), then the
    evidence vanishes and that isolated flag is erased; seeded noise
    elsewhere."""
    rng = np.random.default_rng(7)
    ft, fj = tmild.BayesianTemporalFilter(), jmild.BayesianTemporalFilter()
    erased = 0
    for step in range(12):
        sims = rng.uniform(0.5, 1.5, 10 + step).astype(np.float32)
        if step < 7:
            sims[4] = 30.0
        flagged_before = sum(int(f.sum()) for f in fj.flags)
        pt, pj = ft.update(sims), fj.update(sims)
        assert pt.shape == pj.shape and np.abs(pt - pj).max() <= 1e-6
        assert len(ft.flags) == len(fj.flags)
        assert all(np.array_equal(a, b) for a, b in zip(ft.flags, fj.flags))
        erased += sum(int(f.sum()) for f in fj.flags[:-1]) < flagged_before
    assert erased >= 1, "no retro-erasure happened"
    assert sum(int(f.sum()) for f in fj.flags) == 0


def _detector_pair(n_kf, n_feat, rng, temporal=True):
    """Both packages' detectors over the same keyframes: 4 initial rows, so
    n_kf > 16 doubles the capacity three times; keyframe k shares a quarter
    of its features with keyframe k - 9 (a revisit) and every keyframe
    shares a repeated structure."""
    shared = _rand_desc(rng, n_feat // 4)
    kfs = []
    for k in range(n_kf):
        d = np.concatenate([shared, _rand_desc(rng, n_feat - n_feat // 4)])
        if k >= 9:
            d[n_feat // 4 : n_feat // 2] = _noisy(rng, kfs[k - 9][n_feat // 2 : 3 * n_feat // 4], bits=3)
        kfs.append(d)
    jd = jmild.LoopClosureDetector(feature_capacity=n_feat, initial_keyframes=4, temporal=temporal)
    td = tmild.LoopClosureDetector(feature_capacity=n_feat, initial_keyframes=4, temporal=temporal, device="cpu")
    valid = np.ones(n_feat, bool)
    valid[-3:] = False
    return jd, td, kfs, valid


def test_detector_matches_jax_past_two_doublings():
    rng = np.random.default_rng(2)
    n_feat = 48
    jd, td, kfs, valid = _detector_pair(18, n_feat, rng)
    queries = [_noisy(rng, kfs[k], bits=5) for k in (3, 10, 16)]
    for k, d in enumerate(kfs):
        assert td.insert(_t(d), torch.from_numpy(valid)) == jd.insert(jnp.asarray(d), jnp.asarray(valid)) == k
        if k in (2, 9, 17):  # one query past each stage of the database
            for q in queries:
                sj = jd.similarity(jnp.asarray(q), jnp.ones(n_feat, bool))
                st = td.similarity(_t(q), torch.ones(n_feat, dtype=torch.bool))
                assert st.shape == sj.shape == (k + 1,)
                assert np.abs(st - sj).max() <= 1e-5 * np.abs(sj).max()
                for excl in (0, 1):
                    assert td.select_candidates(_t(q), torch.ones(n_feat, dtype=torch.bool), excl) == \
                        jd.select_candidates(jnp.asarray(q), jnp.ones(n_feat, bool), excl)
    assert td.kcap == jd.kcap == 32  # 4 -> 8 -> 16 -> 32
    qs = np.stack(queries)
    qv = np.ones((len(queries), n_feat), bool)
    qv[1, :5] = False
    bj = jd.similarity_batch(jnp.asarray(qs), jnp.asarray(qv))
    bt = td.similarity_batch(_t(qs), torch.from_numpy(qv))
    assert bt.shape == bj.shape == (3, 18)
    assert np.abs(bt - bj).max() <= 1e-5 * np.abs(bj).max()
    for q in range(3):
        for limit in (17, 9):
            assert td.candidates_from_sims(bt[q], limit) == jd.candidates_from_sims(bj[q], limit)
    # a noisy copy of keyframe 16 finds it
    assert td.candidates_from_sims(bt[2], 17) == [16]
    # the temporal filters advanced in step
    assert len(td.temporal.flags) == len(jd.temporal.flags) > 0
    assert all(np.array_equal(a, b) for a, b in zip(td.temporal.flags, jd.temporal.flags))
    assert np.abs(td.temporal.prev_prob - jd.temporal.prev_prob).max() <= 1e-6


def test_corridor_loop_detected_despite_repeated_structure():
    """`tests/test_lcdetection.py`'s corridor on the port: half of every
    keyframe's features are one repeated structure; tf-idf discounts them,
    so only the true revisit fires, and the repeated structure alone fires
    nowhere."""
    rng = np.random.default_rng(0)
    n_kf, n_feat = 12, 64
    shared = _rand_desc(rng, n_feat // 2)
    uniques = [_rand_desc(rng, n_feat // 2) for _ in range(n_kf)]
    lcd = tmild.LoopClosureDetector(feature_capacity=n_feat, device="cpu")
    jd = jmild.LoopClosureDetector(feature_capacity=n_feat)
    ones = torch.ones(n_feat, dtype=torch.bool)
    for u in uniques:
        d = np.concatenate([shared, u])
        lcd.insert(_t(d), ones)
        jd.insert(jnp.asarray(d), jnp.ones(n_feat, bool))
    q = _noisy(rng, np.concatenate([shared, uniques[3]]), bits=4)
    cands = lcd.select_candidates(_t(q), ones)
    assert cands == [3] and cands == jd.select_candidates(jnp.asarray(q), jnp.ones(n_feat, bool))
    q2 = np.concatenate([shared, _rand_desc(rng, n_feat // 2)])
    assert lcd.select_candidates(_t(q2), ones) == [] == jd.select_candidates(jnp.asarray(q2), jnp.ones(n_feat, bool))
    assert lcd.select_candidates(_t(q), ones, exclude_recent=n_kf) == []


def test_detector_defaults_match_jax():
    import inspect

    p = inspect.signature(jmild.LoopClosureDetector).parameters
    q = inspect.signature(tmild.LoopClosureDetector).parameters
    for name in ("feature_capacity", "initial_keyframes", "temporal"):
        assert q[name].default == p[name].default
    p = inspect.signature(jmild.BayesianTemporalFilter).parameters
    q = inspect.signature(tmild.BayesianTemporalFilter).parameters
    assert {k: v.default for k, v in p.items()} == {k: v.default for k, v in q.items()}
