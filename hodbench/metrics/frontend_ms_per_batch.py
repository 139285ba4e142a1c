"""``frontend_ms_per_batch``: the window's time outside the engine (the
server's ``submit``, queues, answer rows, row cache and futures, the
clients and the event loop, all on one thread) over its batches."""


def read(ctx):
    batches = ctx.stats1["batches"] - ctx.stats0["batches"]
    if batches <= 0:
        return None
    busy = ctx.stats1["busy_seconds"] - ctx.stats0["busy_seconds"]
    return (ctx.window_s - busy) / batches * 1e3
