"""100 x (1 - the union of device intervals over the traced stretch)."""

KIND = "per_layer"
UNIT = "%"


def read(ctx):
    st = ctx.stretch()
    if st is None:
        return None
    busy, window = st
    return 100.0 * (1.0 - busy / window)
