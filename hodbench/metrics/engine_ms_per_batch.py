"""``engine_ms_per_batch``: ``ServerStats.busy_seconds`` over the
window's batches.  The server times each batch around the engine call,
which ends in the answer's copy to the host, so the time is the
batch's whole time in the engine, host and device."""


def read(ctx):
    batches = ctx.stats1["batches"] - ctx.stats0["batches"]
    if batches <= 0:
        return None
    busy = ctx.stats1["busy_seconds"] - ctx.stats0["busy_seconds"]
    return busy / batches * 1e3
