"""Loop-closure detection over binary descriptors (MILD-equivalent): device and host halves.

Port of `onepiece_tpu/lcdetection/mild.py`: the device half (the
constants, `_similarity_scores`, `salient_scores_device`,
`lc_candidates_device`) that the fused systems run, and the host half that
the host-loop systems run (`salient_scores`, `BayesianTemporalFilter`,
`LoopClosureDetector`): numpy statistics over similarity vectors that the
device computes and hands back in one copy.

A query frame's features are scored against every stored keyframe's: each
database feature within Hamming distance 64 contributes
exp(-max(d, 10)^2 / 900), summed per (query feature, keyframe) into the
feature-score table fs (N, N_CAP); tf-idf weighting and the salient-score
statistics then work on that table.

The JAX package materialises the (N, N_CAP * F) distance table for every
query. `mild_feature_scores` never writes it: on the card
(`csrc/hamming.cu`) a block lists one keyframe's valid features in shared
memory and each valid query feature gets a thread that sums its terms in
feature order, reading the term from a 64-entry table; keyframe rows k >= g
(a device int64 scalar) are written 0 without a host read. On CPU tensors
the plain version computes the same terms from the same table, so every
term is bit-equal and only the order of the sums differs.

Frozen copy for the benchmark's reference: the plain version on every device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import hamming

SALIENT_THRESHOLD = 1.5  # ref: MildLCDetector.h salient_score_threshold
MAX_CANDIDATES = 7  # ref: MildLCDetector.h max_candidate_num
MIN_SHARED_SCORE = 0.05  # absolute-evidence floor for candidacy (the JAX package's)
HAMMING_THRESHOLD = 64  # ref: mild.hpp DEFAULT_HAMMING_DISTANCE_THRESHOLD
HAMMING_COVARIANCE = 900.0  # ref: mild.hpp:33
# energy floor = lut_feature_similarity[20] (ref: loop_closure_detector.cpp:214)
_ENERGY_FLOOR = math.exp(-20.0 * 20.0 / HAMMING_COVARIANCE)

# exp(-max(d, 10)^2 / 900) for d < 64, float32, computed once on the host
SIM_LUT = torch.exp(
    -torch.square(torch.clamp(torch.arange(HAMMING_THRESHOLD, dtype=torch.float32), min=10.0))
    / HAMMING_COVARIANCE
)
_KF_ROWS = 4  # keyframes per block of the plain version's distance table


def mild_feature_scores_reference(
    q_desc: torch.Tensor,  # (N, 8) int32
    q_valid: torch.Tensor,  # (N,) bool
    db_desc: torch.Tensor,  # (N_CAP, F, 8) int32
    db_valid: torch.Tensor,  # (N_CAP, F) bool
    g: torch.Tensor,  # () int: keyframe rows k < g take part
) -> torch.Tensor:
    """fs (N, N_CAP) float32: fs[n, k] = sum over f of SIM_LUT[d] where
    db_valid[k, f], k < g, d < 64 and q_valid[n] (0 elsewhere). Reads g on
    the host to skip the rows past it: the plain version serves the CPU and
    the comparisons with the kernel, never the card's main path."""
    n_cap, f = db_desc.shape[:2]
    lut = SIM_LUT.to(q_desc.device)
    fs = torch.zeros((q_desc.shape[0], n_cap), dtype=torch.float32, device=q_desc.device)
    g = min(n_cap, int(g))
    for s in range(0, g, _KF_ROWS):
        e = min(s + _KF_ROWS, g)
        d = hamming.hamming_table_reference(q_desc, db_desc[s:e].reshape(-1, 8)).reshape(-1, e - s, f)
        use = db_valid[s:e][None] & (d < HAMMING_THRESHOLD)
        fs[:, s:e] = torch.where(use, lut[torch.clamp(d, max=HAMMING_THRESHOLD - 1).long()], 0.0).sum(-1)
    return torch.where(q_valid[:, None], fs, 0.0)


_luts: dict[torch.device, torch.Tensor] = {}


def _lut_on(dev: torch.device) -> torch.Tensor:
    """SIM_LUT on the device, copied once per device."""
    if dev not in _luts:
        _luts[dev] = SIM_LUT.to(dev)
    return _luts[dev]


def mild_feature_scores(q_desc, q_valid, db_desc, db_valid, g) -> torch.Tensor:
    """The feature-score table fs (N, N_CAP): the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors."""
    return mild_feature_scores_reference(q_desc, q_valid, db_desc, db_valid, g)


def _tfidf(fs: torch.Tensor, q_valid: torch.Tensor, num_keyframes) -> torch.Tensor:
    """(..., K) tf-idf similarity from the feature scores fs (..., N, K)
    (ref: loop_closure_detector.cpp:213-227)."""
    energy = _ENERGY_FLOOR + torch.sum(fs, dim=-1, keepdim=True)  # (..., N, 1)
    simcount = torch.clamp(torch.sum((fs > 0).to(torch.int32), dim=-1), min=1)
    idf = torch.log(torch.clamp(num_keyframes / simcount.to(torch.float32), min=1.0))  # (..., N)
    contrib = fs / energy * idf[..., None]
    return torch.sum(torch.where(q_valid[..., None], contrib, 0.0), dim=-2)


def _similarity_scores(
    q_desc: torch.Tensor,  # (N, 8) int32
    q_valid: torch.Tensor,  # (N,)
    db_desc: torch.Tensor,  # (K, F, 8) int32 (capacity-padded)
    db_valid: torch.Tensor,  # (K, F)
    num_keyframes: torch.Tensor | int | None = None,  # () actual K for the idf
) -> torch.Tensor:
    """(K,) tf-idf similarity of the query frame to each stored keyframe."""
    k = db_desc.shape[0]
    fs = mild_feature_scores(q_desc, q_valid, db_desc, db_valid, k)
    kdb = k if num_keyframes is None else torch.as_tensor(num_keyframes, device=fs.device).to(torch.float32)
    return _tfidf(fs, q_valid, kdb)


def salient_scores_device(sims: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Salient score over a capacity-padded similarity vector (ref:
    BayesianFilter.hpp:40-100 `calculateSalientScore`): statistics over rows
    [0, g) with the trailing streak of above-average rows trimmed,
    (sim - std) / mean; 3.0 everywhere when no history is left, 1.0 when
    the history is degenerate."""
    n_cap = sims.shape[0]
    idx = torch.arange(n_cap, device=sims.device)
    m = (idx < g).to(torch.float32)
    gf = torch.clamp(g.to(torch.float32), min=1.0)
    avg = torch.sum(sims * m) / gf
    below = (idx < g) & (sims < avg)
    hist = torch.max(torch.where(below, idx, -1))
    sm = (idx < hist).to(torch.float32)
    histf = torch.clamp(hist.to(torch.float32), min=1.0)
    mean = torch.sum(sims * sm) / histf
    delta = torch.sqrt(torch.sum(sm * torch.square(sims - mean))) / torch.clamp(torch.sqrt(histf - 1.0), min=1.0)
    sal = (sims - delta) / torch.clamp(mean, min=1e-12)
    sal = torch.where((mean < 1e-8) | (hist < 3), torch.ones_like(sal), sal)
    return torch.where(hist <= 0, torch.full_like(sal, 3.0), sal)


def top_k_lowest_index(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of a 1-D tensor, lowest index first among equal
    values (as `lax.top_k`): (values, int64 indices)."""
    vals, order = torch.sort(x, descending=True, stable=True)
    return vals[:k], order[:k]


def lc_candidates_device(
    q_desc: torch.Tensor,  # (F, 8) int32
    q_valid: torch.Tensor,  # (F,)
    db_desc: torch.Tensor,  # (N_CAP, F, 8)
    db_valid: torch.Tensor,  # (N_CAP, F)
    g: torch.Tensor,  # () int: DB rows < g take part in the statistics
    limit: torch.Tensor,  # () int: candidates restricted to indices < limit
    exclude: torch.Tensor,  # () int: candidate index to skip (-1 for none)
    max_candidates: int = MAX_CANDIDATES,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Candidate keyframes for one query, on the device (ref:
    MildLCDetector.cpp:7-40 `select_candidates`): tf-idf similarity over
    keyframes [0, g), salient filter, ordering restricted to indices <
    `limit` other than `exclude`, top `max_candidates`. Returns (indices
    (M,) int64, valid (M,) bool: salient score > 1.5)."""
    g = torch.as_tensor(g, device=q_desc.device)
    fs = mild_feature_scores(q_desc, q_valid, db_desc, db_valid, g)
    return candidates_from_scores(fs, q_valid, g, limit, exclude, max_candidates)


def candidates_from_scores(fs, q_valid, g, limit, exclude, max_candidates: int = MAX_CANDIDATES):
    """The second half of `lc_candidates_device`, from the feature scores
    fs (N, N_CAP): tf-idf, salient scores, ordering, top candidates."""
    idx = torch.arange(fs.shape[1], device=fs.device)
    sims = _tfidf(fs, q_valid, g.to(torch.float32))
    sal = salient_scores_device(sims, g)
    sal = torch.where(sims < MIN_SHARED_SCORE, torch.clamp(sal, max=1.0), sal)
    order_mask = (idx < limit) & (idx != exclude)
    vals, top = top_k_lowest_index(torch.where(order_mask, sal, -torch.inf), max_candidates)
    return top, vals > SALIENT_THRESHOLD


# ---------------------------------------------------------------------------
# The host half: the host-loop systems' keyframe database and candidate rules
# ---------------------------------------------------------------------------


def salient_scores(sims: np.ndarray) -> np.ndarray:
    """Reference `calculateSalientScore` (ref: BayesianFilter.hpp:40-100):
    the trailing streak of above-average scores (the adjacent keyframes) is
    trimmed from the statistics, then salient[i] = (sim[i] - std) / mean;
    3.0 everywhere when no history is left, 1.0 when it is degenerate."""
    n = len(sims)
    if n == 0:
        return np.zeros(0, np.float32)
    avg = float(sims.mean())
    # the largest index with sims[i] < avg; the statistics take [0:hist], excluding it
    hist = n - 1
    while hist >= 0 and sims[hist] >= avg:
        hist -= 1
    if hist <= 0:
        return np.full(n, 3.0, np.float32)
    s = sims[:hist]
    mean = float(s.mean())
    if mean < 1e-8 or hist < 3:
        return np.ones(n, np.float32)
    delta = float(np.linalg.norm(s - s.mean()) / max(np.sqrt(hist - 1), 1.0))
    return ((sims - delta) / mean).astype(np.float32)


class BayesianTemporalFilter:
    """Sequential visit-probability filter (ref: BayesianFilter.hpp:103-172).

    `update(sims)` once per query, in keyframe order, returns the visit
    probabilities of the `len(sims) - min_distance` older keyframes. The
    flags (prob > probability_threshold) of every step are kept, and a
    detection supported neither by the two steps before it nor by the step
    after it, within +-4 keyframes, is erased from the last three steps
    (the reference's `privious_visit_flag` surgery)."""

    TRANS = ((0.95, 0.05), (0.05, 0.95))

    def __init__(self, probability_threshold: float = 0.6, non_loop_closure_threshold: float = 4.0,
                 min_shared_score_threshold: float = 4.0, min_distance: int = 1):
        # defaults: ref BayesianFilter.hpp:26-29
        self.probability_threshold = probability_threshold
        self.nlc = non_loop_closure_threshold
        self.min_shared = min_shared_score_threshold
        self.min_distance = min_distance
        self.prev_prob = np.zeros(0, np.float32)
        self.flags: list[np.ndarray] = []

    def update(self, sims: np.ndarray) -> np.ndarray:
        n = len(sims) - self.min_distance
        if n <= 0:
            return np.zeros(0, np.float32)
        s = np.asarray(sims[:n], np.float32)
        mean = float(s.mean())
        delta = float(np.linalg.norm(s - s.mean()) / max(np.sqrt(max(n - 1, 1)), 1.0))
        prob = np.zeros(n, np.float32)
        prev = self.prev_prob
        for i in range(n):
            sal = (s[i] - delta) / mean if mean >= 1e-8 else 1.0
            if s[i] < self.min_shared:
                sal = 1.0
            like = max(1.0, sal)
            lo = max(i - 2, 0)
            hi = min(len(prev) - 1, i + 3)
            alpha = float(prev[lo : hi + 1].max()) if hi >= lo and len(prev) else 0.0
            p1 = like * self.TRANS[1][0] * (1 - alpha) + like * self.TRANS[1][1] * alpha
            p2 = self.nlc * self.TRANS[0][0] * (1 - alpha) + self.nlc * self.TRANS[0][1] * alpha
            prob[i] = p1 / (p1 + p2)
        flags = (prob > self.probability_threshold).astype(np.int32)
        # retro-erasure of isolated detections (ref: BayesianFilter.hpp:139-166)
        if len(self.flags) >= 4:
            prev_f = self.flags[-1]
            rng = len(prev_f)
            i = 0
            while i < rng:
                if prev_f[i] > 0:
                    start = max(i - 4, 0)
                    while i < rng and prev_f[i] > 0:
                        i += 1
                    end = min(i + 4, max(rng - 3, start + 1))
                    if flags[start:end].max(initial=0) == 0:
                        p2f = self.flags[-3][start:end].max(initial=0)
                        p1f = self.flags[-2][start:end].max(initial=0)
                        if p2f + p1f < 2:
                            self.flags[-3][start:end] = 0
                            self.flags[-2][start:end] = 0
                            self.flags[-1][start:end] = 0
                i += 1
        self.prev_prob = prob
        self.flags.append(flags)
        return prob


class LoopClosureDetector:
    """The keyframe descriptor database of the host-loop systems, with
    salient-score candidate selection (ref: MildLCDetector.cpp:7-44).

    The database lives on `device` as capacity-padded tensors, (K_CAP, F, 8)
    int32 descriptor words and (K_CAP, F) validity, K_CAP doubling when
    full. A query scores the whole padded database through
    `mild_feature_scores` (on the card, the Hamming kernel's MILD launch:
    one launch a query, or a batch of queries), and the host reads the
    similarity vector back in one copy for the numpy statistics."""

    def __init__(self, feature_capacity: int = 512, initial_keyframes: int = 64, temporal: bool = False,
                 device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        self.fcap = feature_capacity
        self.kcap = initial_keyframes
        self.db = torch.zeros((self.kcap, feature_capacity, 8), dtype=torch.int32, device=self.device)
        self.db_valid = torch.zeros((self.kcap, feature_capacity), dtype=torch.bool, device=self.device)
        self.num_keyframes = 0
        self.temporal = BayesianTemporalFilter() if temporal else None

    def insert(self, desc: torch.Tensor, valid: torch.Tensor) -> int:
        """Add a keyframe's first `feature_capacity` descriptors; returns its index."""
        k = self.num_keyframes
        if k == self.kcap:
            self.db = torch.cat([self.db, torch.zeros_like(self.db)])
            self.db_valid = torch.cat([self.db_valid, torch.zeros_like(self.db_valid)])
            self.kcap *= 2
        n = min(desc.shape[0], self.fcap)
        self.db[k].zero_()
        self.db_valid[k].zero_()
        self.db[k, :n] = desc[:n].to(self.device)
        self.db_valid[k, :n] = valid[:n].to(self.device)
        self.num_keyframes += 1
        return k

    def _scores(self, q_desc: torch.Tensor, q_valid: torch.Tensor) -> torch.Tensor:
        """(..., K_CAP) tf-idf scores of queries (..., N, 8) against the
        padded database: one `mild_feature_scores` call for all of them.
        Rows past the stored keyframes hold no valid feature, so they score
        0 with or without work: g = num_keyframes skips them."""
        lead, n = q_desc.shape[:-2], q_desc.shape[-2]
        fs = mild_feature_scores(q_desc.reshape(-1, 8).contiguous(), q_valid.reshape(-1).contiguous(),
                                 self.db, self.db_valid, self.num_keyframes)
        return _tfidf(fs.reshape(*lead, n, self.kcap), q_valid, float(self.num_keyframes))

    def similarity(self, desc: torch.Tensor, valid: torch.Tensor) -> np.ndarray:
        """(num_keyframes,) tf-idf similarity of a query frame, read back in one copy."""
        k = self.num_keyframes
        if k == 0:
            return np.zeros(0, np.float32)
        return self._scores(desc, valid)[:k].cpu().numpy()

    def similarity_batch(self, descs: torch.Tensor, valids: torch.Tensor) -> np.ndarray:
        """(Q, num_keyframes) scores of Q query frames (Q, N, 8): one launch
        and one copy for the batch."""
        k = self.num_keyframes
        if k == 0:
            return np.zeros((descs.shape[0], 0), np.float32)
        return self._scores(descs, valids)[:, :k].cpu().numpy()

    def candidates_from_sims(self, sims: np.ndarray, limit: int) -> list[int]:
        """Candidates from precomputed scores, among keyframes < limit: the
        statistics run over the whole vector, only the ordering is limited."""
        if limit <= 0:
            return []
        salient = salient_scores(sims)
        # low absolute evidence is no loop, whatever the history (ref: BayesianFilter.hpp:126-129)
        salient = np.where(sims < MIN_SHARED_SCORE, np.minimum(salient, 1.0), salient)
        order = np.argsort(-salient[:limit], kind="stable")
        return [int(i) for i in order[:MAX_CANDIDATES] if salient[i] > SALIENT_THRESHOLD]

    def select_candidates(self, desc: torch.Tensor, valid: torch.Tensor, exclude_recent: int = 1) -> list[int]:
        """Keyframes likely to close a loop with this frame (salient score >
        1.5, the top 7), the `exclude_recent` newest left out. With
        `temporal=True` the Bayesian filter advances on every call."""
        k = self.num_keyframes
        if k <= exclude_recent:
            return []
        sims = self.similarity(desc, valid)
        if self.temporal is not None:
            self.temporal.update(sims)
        return self.candidates_from_sims(sims, k - exclude_recent)
