"""100 x the least time of the work that `roofline/dense_gn.json` names over
the device time of its kernels in the traced stretch."""

KIND = "per_layer"
UNIT = "%"


def read(ctx):
    return ctx.roofline_share("dense_gn")
