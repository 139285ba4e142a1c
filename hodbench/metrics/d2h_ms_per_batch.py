"""``d2h_ms_per_batch``: device time of the window's device-to-host
copies (the answers leaving the card) over its batches."""


def read(ctx):
    batches = ctx.stats1["batches"] - ctx.stats0["batches"]
    if ctx.events is None or batches <= 0:
        return None
    ns = sum(b - a for name, a, b in ctx.events if "DtoH" in name)
    return ns / 1e6 / batches if ns else None
