"""``idle_share``: the share of the traced window in which no kernel,
copy or memset ran on the card, in percent."""
from hodbench import devtrace


def read(ctx):
    if not ctx.events or not ctx.trace_window_s:
        return None
    busy = devtrace.busy_ns(ctx.events) / 1e9
    return 100.0 * (1.0 - busy / ctx.trace_window_s)
