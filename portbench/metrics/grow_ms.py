"""Mean host time of a `maybe_grow` that grew the pool, between two
synchronisations, over the window's growths."""

KIND = "per_layer"
UNIT = "ms"


def read(ctx):
    return sum(ctx.grow_ms) / len(ctx.grow_ms) if ctx.grow_ms else None
