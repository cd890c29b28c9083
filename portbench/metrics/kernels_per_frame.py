"""Device operations (kernels, copies, fills) of the traced scans, over
their frames."""

KIND = "per_layer"
UNIT = "kernels/frame"


def read(ctx):
    n = ctx.traced_frames()
    return ctx.device_ops() / n if n else None
