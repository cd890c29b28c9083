"""Self time of the dense tracking spans (`tracking.*`: preprocess, one a
pyramid level, the pose chain) in the traced scan, over its frames."""

from portbench.metrics import _spans

KIND = "per_layer"
UNIT = "ms/frame"


def read(ctx):
    return _spans.layer_ms(ctx, "tracking")
