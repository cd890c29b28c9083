"""From the start of the process to the opening of the window: imports,
the kernels' load (and build, in a fresh checkout), rendering the inputs,
one warm-up scan at the cell's shapes."""

KIND = "end_to_end"
UNIT = "s"


def read(ctx):
    return ctx.setup_s
