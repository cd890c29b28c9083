"""Self time of the bundle adjustment's spans (`ba.*`: the linker, the
points' composition, the LM steps) in the traced scan, over its frames."""

from portbench.metrics import _spans

KIND = "per_layer"
UNIT = "ms/frame"


def read(ctx):
    return _spans.layer_ms(ctx, "ba")
