"""``build_s``: host seconds inside ``build_hod_fast`` (the HoD
contraction, paper §4), by the benchmark's clock around the call."""


def read(ctx):
    return ctx.build_s
