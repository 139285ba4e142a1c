"""``edge_relax_roofline``: the forward and backward sweeps, once each a
batch at the server's batch size, as a share of their roofline: the
batches' bound from the index's real plan arcs (``yardstick.sweep_cost``
of ``plan_f`` and ``plan_b``) over the device time of every
``relax_sweep`` kernel in the window, in percent."""
from hodbench import yardstick


def read(ctx):
    batches = ctx.stats1["batches"] - ctx.stats0["batches"]
    if ctx.events is None or batches <= 0:
        return None
    ns = sum(b - a for name, a, b in ctx.events if "relax_sweep" in name)
    if not ns:
        return None
    bound = sum(yardstick.bound_s(*yardstick.sweep_cost(p, ctx.batch_size))
                for p in (ctx.index.plan_f, ctx.index.plan_b))
    return 100.0 * batches * bound / (ns / 1e9)
