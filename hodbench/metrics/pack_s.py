"""``pack_s``: host seconds inside ``pack_index`` (the packed layout, the
sweep plans and the core closure on the card); it returns numpy, so the
card has finished."""


def read(ctx):
    return ctx.pack_s
