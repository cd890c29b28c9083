"""Self time of the sparse front end's spans (`sparse.*`: the features, each
track of the main loop and the failure ladder, their matching and RANSAC)
in the traced scan, over its frames."""

from portbench.metrics import _spans

KIND = "per_layer"
UNIT = "ms/frame"


def read(ctx):
    return _spans.layer_ms(ctx, "sparse")
