"""Mean host time of a scan's end (`finalize`, `to_volume`, marching cubes,
the dedup on the card) between two synchronisations, over the window's scans."""

KIND = "per_layer"
UNIT = "ms"


def read(ctx):
    if not ctx.cfg.get("mesh"):
        return None
    return sum(ctx.mesh_ms) / len(ctx.mesh_ms) if ctx.mesh_ms else None
