"""Bytes and operations of the traced scan's rigid-RANSAC launches, as
`chip_smoke.ransac_bytes_ops` counts one, at each registration's
correspondences (the source submap's cloud capacity) that the reference's
recount records, and the configuration's hypotheses and sample size."""

FIT_OPS_PER_SAMPLE = 53
FIT_OPS = 641
SCORE_OPS = 28


def count(cfg, mix, out, counts):
    if not counts or not counts.get("ransac"):
        return None
    h, s = cfg["num_hypotheses"], cfg["sample_size"]
    n_bytes = sum(n * 25 + 8 * h * s + 64 + 8 + n * 9 for n in counts["ransac"])
    ops = sum(h * (FIT_OPS_PER_SAMPLE * s + FIT_OPS) + (h + 1) * n * SCORE_OPS for n in counts["ransac"])
    return dict(bytes=n_bytes, ops=ops)
