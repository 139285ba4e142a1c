"""``qps``: answers received in the window (row-cache hits count) over
the window's length, on the host clock."""


def read(ctx):
    return ctx.answered / ctx.window_s if ctx.window_s > 0 else None
