"""Mean whole length of the `grow.pool` spans that grew the pool in the
traced scan: `maybe_grow` timed inside the program, without the
synchronisations that `grow_ms` puts around it."""

from portbench.metrics import _spans

KIND = "per_layer"
UNIT = "ms"


def read(ctx):
    t = _spans.traced(ctx)
    if t is None:
        return None
    grew = [s.end_ns - s.start_ns for _, s in _spans.in_stretch(*t)
            if s.name == "grow.pool" and s.attrs.get("grew")]
    return sum(grew) / len(grew) / 1e6 if grew else None
