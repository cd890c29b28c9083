"""Self time of the `sync.*` spans in the traced scan, over its frames: the
host waiting for the device at the program's own reads."""

from portbench.metrics import _spans

KIND = "per_layer"
UNIT = "ms/frame"


def read(ctx):
    return _spans.layer_ms(ctx, "sync")
