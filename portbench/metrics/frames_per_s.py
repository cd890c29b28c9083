"""Frames of every chunk finished inside the window, over the window."""

KIND = "end_to_end"
UNIT = "frames/s"


def read(ctx):
    return ctx.frames / ctx.window_s if ctx.frames else None
