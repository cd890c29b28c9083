"""Self time of the loop-closure spans (`closure.*`: MILD candidates, the
pair tracks and their edges, the pose graph) in the traced scan, over its
frames."""

from portbench.metrics import _spans

KIND = "per_layer"
UNIT = "ms/frame"


def read(ctx):
    return _spans.layer_ms(ctx, "closure")
