"""The program's synchronising CUDA calls over the window (sync debug mode
"warn", counted inside the program's calls only), over the window's frames."""

KIND = "per_layer"
UNIT = "syncs/frame"


def read(ctx):
    if ctx.syncs is None or not ctx.frames:
        return None
    return ctx.syncs / ctx.frames
