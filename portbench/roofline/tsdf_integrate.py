"""Bytes and operations of a scan's TSDF updates, from the reference's
recount of each frame at the program's poses (`counts`: touched blocks,
voxels updated, of them from weight 0), as `chip_smoke.py` counts them."""

BYTES_FRESH = 24
BYTES_UPDATE = 40
OPS_PER_VOXEL = 30
OPS_PER_UPDATE = 20


def count(cfg, mix, out, counts):
    if not counts:
        return None
    n_bytes = sum(BYTES_FRESH * fresh + BYTES_UPDATE * (upd - fresh) for _, upd, fresh in counts)
    ops = sum(OPS_PER_VOXEL * 512 * blocks + OPS_PER_UPDATE * upd for blocks, upd, _ in counts)
    return dict(bytes=n_bytes, ops=ops)
