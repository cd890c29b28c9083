"""Bytes of the dense tracker's Gauss-Newton steps in one scan: every
frame after the first takes `iters[l]` steps at pyramid level l, each of
which reads 40 B a pixel of that level (the count of `chip_smoke.py`'s
bound). Operations are left at 0: at the main path's sizes the bytes bind
(98 operations a pixel and 166 an inlier take under a sixth of the bytes'
time), so the bound can only be lower than the true one, never higher."""

BYTES_PER_PIXEL = 40


def count(cfg, mix, out, counts):
    if out is None:
        return None
    tracked = out.poses.shape[0] - 1
    w, h = cfg["camera"]["width"], cfg["camera"]["height"]
    per_frame = 0
    for level, steps in enumerate(reversed(cfg["iters"])):  # iters are coarsest first
        per_frame += BYTES_PER_PIXEL * (w >> level) * (h >> level) * steps
    return dict(bytes=tracked * per_frame, ops=0)
