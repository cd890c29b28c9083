"""The program's own count of its waits for the device (the `sync.*`
counters) in the traced scan, over its frames: the counterpart of
`host_syncs_per_frame`, site by site in the program."""

from portbench.metrics import _spans

KIND = "per_layer"
UNIT = "syncs/frame"


def read(ctx):
    n = _spans.syncs(ctx)
    return n / ctx.traced_frames() if n is not None and ctx.traced_frames() else None
