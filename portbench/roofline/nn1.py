"""Bytes and operations of the traced scan's nn1 launches, as
`chip_smoke.py` counts one (8 operations a query and valid target), from
the shapes of each ICP call that the reference's recount records
(`reference/dense_slam.recount`): `icp_iters + 1` launches a call."""

OPS_PER_PAIR = 8


def count(cfg, mix, out, counts):
    if not counts or not counts.get("icp"):
        return None
    launches = cfg["icp_iters"] + 1
    n_bytes = sum(launches * (12 * n + 12 * m + m + 8 * n) for n, m, _ in counts["icp"])
    ops = sum(launches * OPS_PER_PAIR * n * v for n, _, v in counts["icp"])
    return dict(bytes=n_bytes, ops=ops)
