"""100 x the least time of the work that `roofline/ba_schur.json` names over
the device time of its kernels in the traced stretch."""

KIND = "per_layer"
UNIT = "%"


def read(ctx):
    return ctx.roofline_share("ba_schur")
