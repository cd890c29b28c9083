"""The post-hoc reconstruction of the traced scan (the `reconstruct.posthoc`
span and everything it encloses: every 8th frame's bilateral filter and
TSDF integration, marching cubes, the vertex dedup), ms a scan."""

from portbench.metrics import _spans

KIND = "per_layer"
UNIT = "ms/scan"


def read(ctx):
    t = _spans.traced(ctx)
    if t is None:
        return None
    found = [s for _, s in _spans.in_stretch(*t) if s.name == "reconstruct.posthoc"]
    return sum(s.end_ns - s.start_ns for s in found) / 1e6 if found else None
