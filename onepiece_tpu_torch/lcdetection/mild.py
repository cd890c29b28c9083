"""Loop-closure candidates over binary descriptors (MILD-equivalent), on the device.

Port of the device half of `onepiece_tpu/lcdetection/mild.py`: the
constants, `_similarity_scores`, `salient_scores_device` and
`lc_candidates_device`. (The host `BayesianTemporalFilter` and
`LoopClosureDetector` serve only the host-loop systems and are not ported.)

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
"""

from __future__ import annotations

import math

import torch

from .. import _build
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


def _mild_feature_scores_cuda(q_desc, q_valid, db_desc, db_valid, g):
    dev = q_desc.device
    n = q_desc.shape[0]
    n_cap, f = db_desc.shape[:2]
    _build.require(q_desc, "q_desc", torch.int32, (n, 8), dev, align=16)
    _build.require(q_valid, "q_valid", torch.bool, (n,), dev)
    _build.require(db_desc, "db_desc", torch.int32, (n_cap, f, 8), dev, align=16)
    _build.require(db_valid, "db_valid", torch.bool, (n_cap, f), dev)
    # a Python int becomes a device scalar by a fill, not a copy from the
    # host; the path's int64 device scalar is read by the kernel as it is
    g = (torch.full((), g, dtype=torch.int64, device=dev) if isinstance(g, int)
         else g.to(device=dev, dtype=torch.int64).reshape(()))
    fs = torch.empty((n, n_cap), dtype=torch.float32, device=dev)
    if n == 0 or n_cap == 0:
        return fs
    lut = _lut_on(dev)
    err = _build.library().mild_feature_scores(
        q_desc.data_ptr(), q_valid.data_ptr(), db_desc.data_ptr(), db_valid.data_ptr(), g.data_ptr(),
        lut.data_ptr(), n, n_cap, f, fs.data_ptr(), _build.stream_handle(q_desc),
    )
    _build.check(err, _build.HAMMING)
    _build.HAMMING.launches += 1
    return fs


_luts: dict[torch.device, torch.Tensor] = {}


def _lut_on(dev: torch.device) -> torch.Tensor:
    """SIM_LUT on the device, copied once per device."""
    if dev not in _luts:
        _luts[dev] = SIM_LUT.to(dev)
    return _luts[dev]


def mild_feature_scores(q_desc, q_valid, db_desc, db_valid, g) -> torch.Tensor:
    """The feature-score table fs (N, N_CAP): the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if q_desc.is_cuda:
        return _mild_feature_scores_cuda(q_desc, q_valid, db_desc, db_valid, g)
    if q_desc.device.type == "cpu":
        return mild_feature_scores_reference(q_desc, q_valid, db_desc, db_valid, g)
    raise ValueError(f"mild_feature_scores: unsupported device {q_desc.device}")


def _tfidf(fs: torch.Tensor, q_valid: torch.Tensor, num_keyframes) -> torch.Tensor:
    """(K,) tf-idf similarity from the feature scores (ref:
    loop_closure_detector.cpp:213-227)."""
    energy = _ENERGY_FLOOR + torch.sum(fs, dim=-1, keepdim=True)  # (N, 1)
    simcount = torch.clamp(torch.sum((fs > 0).to(torch.int32), dim=-1), min=1)
    idf = torch.log(torch.clamp(num_keyframes / simcount.to(torch.float32), min=1.0))  # (N,)
    contrib = fs / energy * idf[:, None]
    return torch.sum(torch.where(q_valid[:, None], contrib, 0.0), dim=0)


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
