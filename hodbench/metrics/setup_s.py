"""``setup_s``: from the process's start to the window's: imports, the
graph, ``build_hod_fast``, ``pack_index`` with the closure on the card,
the engine's upload, the server's warm-up and the mix's warm-up
traffic (and, in a checkout's first run, the kernels' nvcc build)."""


def read(ctx):
    return ctx.setup_s
