"""The program's counted waits for the device (the `n` of each `sync.*`
span) inside a `registration.*` span of the traced scan, over its frames:
the host reads of submap registration (the compaction's count, each ICP's
and registration's result, each Kabsch SVD, the pose graph's transfers)."""

from portbench.metrics import _spans

KIND = "per_layer"
UNIT = "syncs/frame"


def read(ctx):
    t = _spans.traced(ctx)
    if t is None or not ctx.traced_frames():
        return None
    spans = t[0]
    kept = _spans.in_stretch(*t)
    if not any(s.name.startswith("registration.") for _, s in kept):
        return None
    n = 0
    for _, s in kept:
        if not s.name.startswith("sync."):
            continue
        p = s.parent
        while p >= 0 and not spans[p].name.startswith("registration."):
            p = spans[p].parent
        if p >= 0:
            n += s.attrs.get("n", 1)
    return n / ctx.traced_frames()
