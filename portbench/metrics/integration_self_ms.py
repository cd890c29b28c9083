"""Self time of the integration spans (`integration.*`: the bilateral
filter, the touched keys, the hash insert, the fusion) in the traced scan,
over its frames. The pool's growth is `grow.pool`, apart."""

from portbench.metrics import _spans

KIND = "per_layer"
UNIT = "ms/frame"


def read(ctx):
    return _spans.layer_ms(ctx, "integration")
