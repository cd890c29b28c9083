"""The 95th percentile over every chunk of the window: from
the hand-in of its frames until the device has finished it. Read only
where the mix asks for a tail (enough chunks for ten beyond it)."""

KIND = "end_to_end"
UNIT = "ms"


def read(ctx):
    if not ctx.mix.get("chunk_tail"):
        return None
    from portbench.metrics import p95

    return p95(ctx.chunk_ms)
