"""``tropical_matmul_roofline``: the core search's min-plus product,
``[S, C] x [C, C]`` once a batch at the server's batch size S, as a
share of its roofline: the batches' bound (``yardstick.minplus_cost``)
over the device time of every ``minplus`` kernel in the window (the
split-K pass and its combine), in percent."""
from hodbench import yardstick


def read(ctx):
    batches = ctx.stats1["batches"] - ctx.stats0["batches"]
    if ctx.events is None or batches <= 0 or ctx.index.n_core == 0:
        return None
    ns = sum(b - a for name, a, b in ctx.events if "minplus" in name)
    if not ns:
        return None
    bound = yardstick.bound_s(*yardstick.minplus_cost(ctx.batch_size,
                                                      ctx.index.n_core))
    return 100.0 * batches * bound / (ns / 1e9)
