"""Rank-side bodies of ``tests/test_torch_block_init.py``: the port and
torch only, never JAX.

:func:`gloo_battery` (``torchdist.Ranks``, one spawn of 4 gloo ranks)
serves the meshes (2, 2), (1, 2) and (1, 3): every rank makes all
three (the second over ranks 0 and 1, the third over ranks 0 to 2).  On
each mesh a rank of it builds every smoke cell of the payload twice,
whole (no rules: the world-1 cell) and under the cell's rules, and
compares every leaf of the rank's state (an LM's or rm2's weights, a
train cell's AdamW state, a decode cell's caches) with the cut of the
whole cell's leaf, bit for bit.  Each mesh runs at the draw's tile size
and again at TINY_TILE bytes, where a smoke leaf spans many tiles and
a block meets some of them in part.

The smoke widths (64, 4 heads, 2 KV heads, 8 experts, 1,000 table rows,
gemma3's window of 16) do not split over 3 ranks, so on (1, 3) every
smoke config is widened by 3/2 (:func:`widened`) and a smoke decode
cell's cache to 192 positions: the same cells at widths that 3
divides.

:func:`fake_battery` runs in a child process: as rank 0 and rank 255 of
a ``"fake"`` group of 256 on the 16x16 mesh, the non-abstract
``build_cell`` of each full-size cell under ``FakeTensorMode``, its
build tracked by ``op_analysis.LiveBytes`` and its tiles counted,
against ``build_cell(abstract=True)``'s argument bytes.
"""
import contextlib
import dataclasses

import torch

#: A tile of 1,024 f32 elements: a smoke leaf spans many.
TINY_TILE = 4096

LM = ("glm4-9b", "command-r-35b", "gemma3-12b", "granite-moe-1b-a400m",
      "qwen3-moe-30b-a3b")


def widen(cfg):
    """``cfg`` (an LM's or rm2's smoke config) at widths 3 divides."""
    from repro_torch.models.dlrm import DLRMConfig
    if isinstance(cfg, DLRMConfig):
        return dataclasses.replace(cfg, vocab_per_table=999)
    moe = cfg.moe and dataclasses.replace(cfg.moe, n_experts=6, d_ff=48)
    return dataclasses.replace(cfg, d_model=96, n_heads=6, n_kv_heads=3,
                               head_dim=16, d_ff=0 if moe else 240,
                               vocab=768, moe=moe,
                               sliding_window=cfg.sliding_window and 24)


@contextlib.contextmanager
def widened():
    """Every LM's and rm2's smoke config :func:`widen`-ed, and a smoke
    decode cell's cache 192 positions long, for the block."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps
    mods = [get_arch(a) for a in LM + ("dlrm-rm2",)]
    old = [m.smoke_config for m in mods], steps.SMOKE_DECODE_SEQ
    for m in mods:
        cfg = widen(m.smoke_config())
        m.smoke_config = lambda cfg=cfg: cfg
    steps.SMOKE_DECODE_SEQ = 192
    try:
        yield
    finally:
        for m, f in zip(mods, old[0]):
            m.smoke_config = f
        steps.SMOKE_DECODE_SEQ = old[1]


@contextlib.contextmanager
def tile_bytes(n):
    from repro_torch.models import init
    old, init.TILE_BYTES = init.TILE_BYTES, n
    try:
        yield
    finally:
        init.TILE_BYTES = old


def state_args(cell) -> int:
    """How many of ``cell.args`` lead its state: a decode cell's weights
    and caches, any other cell's weights (with a train cell's AdamW
    state)."""
    return 2 if cell.kind == "decode" else 1


def compare(whole, cell):
    """(leaves compared, paths of those unequal): each leaf of ``cell``'s
    state against the cut of ``whole``'s under ``cell.in_shardings``."""
    from repro_torch import shardlib as sl
    from repro_torch.tree import flatten_with_paths, leaves
    n = state_args(cell)
    got = flatten_with_paths(cell.args[:n])
    want = leaves(whole.args[:n])
    shs = leaves(cell.in_shardings[:n])
    assert len(got) == len(want) == len(shs), (len(got), len(want), len(shs))
    bad = []
    for (path, g), w, s in zip(got, want, shs):
        cut = sl.local_block(w, s.spec, s.mesh)
        if (g.dtype, g.shape) != (cut.dtype, cut.shape) or \
                not torch.equal(g, cut):
            bad.append(path)
    return len(got), bad


def gloo_battery(rank, world, p):
    from repro_torch import shardlib as sl
    from repro_torch.launch.steps import build_cell, rules_for
    names = ("data", "model")
    meshes = [((2, 2), sl.make_mesh((2, 2), names, "cpu")),
              ((1, 2), sl.make_mesh((1, 2), names, "cpu", ranks=range(2))),
              ((1, 3), sl.make_mesh((1, 3), names, "cpu", ranks=range(3)))]
    out = {}
    for shape, mesh in meshes:
        if mesh is None:
            continue
        wide = widened() if shape == (1, 3) else contextlib.nullcontext()
        with wide:
            for tile in (None, TINY_TILE):
                sized = (tile_bytes(tile) if tile else
                         contextlib.nullcontext())
                with sized:
                    for arch, cell_shape in p["cells"]:
                        whole = build_cell(arch, cell_shape, smoke=True,
                                           device="cpu")
                        with sl.axis_rules(mesh, rules_for(arch, cell_shape,
                                                           mesh)):
                            cell = build_cell(arch, cell_shape, smoke=True,
                                              device="cpu")
                        out[(shape, tile, arch, cell_shape)] = compare(whole,
                                                                       cell)
    return out


def fake_battery(cells):
    """For each ``(arch, shape, batch)`` of ``cells`` and each of rank 0
    and rank 255 of the 16x16 mesh: ``[arch, shape, rank, the build's
    peak live bytes, its argument bytes, the abstract cell's argument
    bytes, the tiles it drew, their f32 bytes]``."""
    import math

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch import shardlib as sl
    from repro_torch.device import fake_device
    from repro_torch.launch.dryrun import fake_mesh
    from repro_torch.launch.mesh import production_mesh_shape
    from repro_torch.launch.op_analysis import LiveBytes, storage_bytes
    from repro_torch.launch.steps import build_cell, rules_for
    from repro_torch.models import init
    shape, names = production_mesh_shape()
    drawn = []
    real = init.draw_tile

    def counted(path, index, tile, *rest):
        drawn.append(4 * math.prod(tile))
        return real(path, index, tile, *rest)
    init.draw_tile = counted
    out = []
    try:
        for arch, cell_shape, batch in cells:
            for rank in (0, 255):
                with fake_mesh(shape, names, rank) as mesh, \
                        sl.axis_rules(mesh, rules_for(arch, cell_shape,
                                                      mesh)):
                    abstract = storage_bytes(build_cell(
                        arch, cell_shape, batch=batch, abstract=True).args)
                    drawn.clear()
                    with FakeTensorMode(allow_non_fake_inputs=True), \
                            LiveBytes(()) as live:
                        cell = build_cell(arch, cell_shape, batch=batch,
                                          device=fake_device())
                        args = storage_bytes(cell.args)
                        del cell
                out.append([arch, cell_shape, rank, live.peak, args,
                            abstract, len(drawn), sum(drawn)])
    finally:
        init.draw_tile = real
    return out
