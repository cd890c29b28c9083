"""Self time of the meshing spans (`meshing.*`: finalize, the volume, the
extraction, the dedup) of the traced scan: a scan's end timed inside the
program, the counterpart of `mesh_ms`."""

from portbench.metrics import _spans

KIND = "per_layer"
UNIT = "ms/scan"


def read(ctx):
    return _spans.layer_ms(ctx, "meshing", per_frame=False)
