"""100 x the least time of the work that `roofline/marching_cubes.json` names over
the device time of its kernels in the traced stretch."""

KIND = "per_layer"
UNIT = "%"


def read(ctx):
    return ctx.roofline_share("marching_cubes")
