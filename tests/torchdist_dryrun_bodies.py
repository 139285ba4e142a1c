"""Rank-side body of ``tests/test_torch_dryrun.py`` (``torchdist.Ranks``):
the port and torch only, never JAX.

One spawn of 4 ranks serves the meshes (2, 2) and (1, 2): every rank
makes both (the second over ranks 0 and 1), then (2, 2) runs on all
four and (1, 2) on the first two.  On each mesh, each rank builds every
smoke cell of the payload under its rules, concrete and abstract, and
returns both leaf signatures; for the cells it steps, it also runs one
concrete step under ``OpAnalysis`` (the collective bytes it sends, by
kind) and adds up its argument blocks' bytes from ``block_slices``.
"""
import torch


def _sigs(tree):
    from repro_torch.tree import leaves
    return [(tuple(t.shape), str(t.dtype)) if isinstance(t, torch.Tensor)
            else repr(t) for t in leaves(tree)]


def _block_bytes(whole, shardings, mesh) -> int:
    """Bytes of this rank's blocks of the leaves of ``whole`` under the
    ``NamedSharding`` leaves of ``shardings``."""
    from repro_torch import shardlib as sl
    from repro_torch.tree import leaves
    total = 0
    ts = [t for t in leaves(whole) if isinstance(t, torch.Tensor)]
    shs = leaves(shardings)
    assert len(ts) == len(shs), (len(ts), len(shs))
    for t, s in zip(ts, shs):
        n = 1
        for sl_ in sl.block_slices(t.shape, s.spec, mesh):
            n *= sl_.stop - sl_.start
        total += n * t.element_size()
    return total


def dryrun_battery(rank, world, p):
    from repro_torch import shardlib as sl
    from repro_torch.launch.op_analysis import OpAnalysis
    from repro_torch.launch.steps import build_cell, rules_for
    meshes = [((2, 2), sl.make_mesh((2, 2), ("data", "model"), "cpu")),
              ((1, 2), sl.make_mesh((1, 2), ("data", "model"), "cpu",
                                    ranks=range(2)))]
    out = {}
    for shape, mesh in meshes:
        if mesh is None:
            continue
        res = out[shape] = {}
        for arch, cell_shape in p["cells"]:
            whole = build_cell(arch, cell_shape, smoke=True, device="cpu")
            with sl.axis_rules(mesh, rules_for(arch, cell_shape, mesh)):
                cell = build_cell(arch, cell_shape, smoke=True, device="cpu")
                fake = build_cell(arch, cell_shape, smoke=True,
                                  abstract=True)
                got = {"concrete": _sigs(cell.args),
                       "abstract": _sigs(fake.args)}
                if (arch, cell_shape) in p["stepped"]:
                    got["block_bytes"] = _block_bytes(
                        whole.args, cell.in_shardings, mesh)
                    with OpAnalysis() as oa:
                        cell.run()
                    got["collectives"] = oa.report()["collectives"]
            res[(arch, cell_shape)] = got
    return out
