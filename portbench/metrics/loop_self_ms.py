"""Self time of the system loop's spans (`loop.*`: a chunk, a frame, the
sparse loop's ladder and promotions) in the traced scan, over its frames."""

from portbench.metrics import _spans

KIND = "per_layer"
UNIT = "ms/frame"


def read(ctx):
    return _spans.layer_ms(ctx, "loop")
