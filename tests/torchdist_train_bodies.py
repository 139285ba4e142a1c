"""Rank-side bodies of the sharded GNN and recsys train tests
(``tests/test_torch_sharded_gnn.py``, ``tests/test_torch_sharded_recsys
.py``).  This module imports the port and torch only, never JAX: every
rank imports it.  Each body returns plain Python and numpy values, which
the parent holds to the JAX package's unsharded cells.

A payload carries the parameters (numpy trees, the port's
``init_params`` at seed 0, which the parent also gives the JAX cells)
and a schedule: stages run one after another, and within a stage each
mesh takes its own ranks.  Every rank makes every mesh first (a
``make_mesh`` is collective over the whole group), then runs the cases
of the meshes it belongs to.  Every rank returns its losses and norms;
the whole tensors (gradients, parameters, AdamW's m and v) come back
from a mesh's first rank only.
"""
#: Train steps of every case after the gradient check.
STEPS = 3


def _np_leaves(tree):
    from repro_torch.tree import leaves
    return [t.detach().numpy() for t in leaves(tree)]


def _gnn_state(cell, params_np):
    """The cell's state from ``params_np`` (AdamW at count 0), cut to this
    rank's blocks (the parameters are replicated: whole)."""
    from repro_torch.models.convert import gnn_params_from_numpy, local_blocks
    from repro_torch.optim import adamw_init
    params = gnn_params_from_numpy(params_np, cell.arch, cell.meta["cfg"],
                                   device="cpu")
    return local_blocks({"params": params, "opt": adamw_init(params)},
                        cell.in_shardings[0])


def gnn_case(mesh, p, arch, shape, variant, first):
    """``arch``'s smoke ``shape`` cell built under ``rules_gnn`` with
    ``variant``'s layout: loss and gradients at the payload's parameters
    (``gnn_value_and_grad``), then STEPS steps of the cell on its
    batches."""
    from repro_torch import shardlib as sl
    from repro_torch.launch import steps
    with sl.axis_rules(mesh, steps.rules_for(arch, shape, mesh)):
        cell = steps.build_cell(arch, shape, smoke=True, device="cpu",
                                variant=variant)
        state = _gnn_state(cell, p["params"][arch, shape])
        loss, grads = steps.gnn_value_and_grad(
            steps.GNN_MODULES[arch], state["params"], cell.args[1],
            cell.meta["cfg"])
        losses, gnorms = [], []
        for i in range(STEPS):
            _, m = cell.fn(state, *cell.batch_at(i))
            losses.append(m["loss"].item())
            gnorms.append(m["gnorm"].item())
    out = {"loss0": loss.item(), "losses": losses, "gnorms": gnorms,
           "n_nodes": cell.args[1].n_nodes,
           "edges": cell.args[1].src.shape[0],
           "count": int(state["opt"].count)}
    if first:
        out.update(grads=_np_leaves(grads), params=_np_leaves(
            state["params"]), m=_np_leaves(state["opt"].m),
            v=_np_leaves(state["opt"].v))
    return out


def dst_ranged_case(mesh, p, first):
    """EquiformerV2's ``dst_ranged`` layout of ``p["dst"]``'s bucketed
    graph laid out for the mesh: loss and gradients, or the error of a
    mesh whose node blocks its chunks do not fall in."""
    import dataclasses

    from repro_torch import shardlib as sl
    from repro_torch.data import bucket_edges_by_dst, make_graph_batch
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import rules_gnn
    from repro_torch.models.convert import gnn_params_from_numpy, local_blocks
    from repro_torch.models.gnn import equiformer_v2 as teq
    d = p["dst"]
    base = steps.build_cell("equiformer-v2", "full_graph_sm", smoke=True,
                            device="cpu").meta["cfg"]
    cfg = dataclasses.replace(base, edge_layout="dst_ranged",
                              edge_chunk=d["edge_chunk"])
    g = bucket_edges_by_dst(make_graph_batch(
        d["n"], d["e"], cfg.d_in, n_classes=7, device="cpu"), d["buckets"],
        pad_factor=d["pad"])
    params = gnn_params_from_numpy(d["params"], "equiformer-v2", cfg,
                                   device="cpu")
    with sl.axis_rules(mesh, rules_gnn(mesh)):
        try:
            whole = steps.gnn_mesh_layout("equiformer-v2", cfg, g)
        except ValueError as err:
            return {"raised": str(err)}
        blocks = local_blocks(whole, steps._gnn_batch_shardings(whole))
        loss, grads = steps.gnn_value_and_grad(teq, params, blocks, cfg)
    out = {"loss0": loss.item(), "n_nodes": whole.n_nodes,
           "edges": whole.src.shape[0]}
    if first:
        out["grads"] = _np_leaves(grads)
    return out


def prims_case(mesh, p):
    """``common``'s primitives on this rank's edge and node blocks of
    ``p["prims"]`` under ``rules_gnn``, each result gathered whole."""
    import torch

    from repro_torch import shardlib as sl
    from repro_torch.launch.mesh import rules_gnn
    from repro_torch.models.gnn import common
    t = {k: torch.from_numpy(v) for k, v in p["prims"].items()}
    n = t["x"].shape[0]
    with sl.axis_rules(mesh, rules_gnn(mesh)):
        edges, nodes = sl.logical_to_spec("edges"), sl.logical_to_spec(
            "nodes")
        idx = sl.local_block(t["idx"], edges)
        vals = sl.local_block(t["vals"], edges)
        out = {"max": sl.gather_blocks(common.scatter_max(vals, idx, n),
                                       nodes),
               "deg": sl.gather_blocks(common.degrees(idx, n), nodes),
               "softmax": sl.gather_blocks(
                   common.segment_softmax(vals, idx, n), edges),
               "readout": common.graph_readout(
                   sl.local_block(t["x"], nodes),
                   sl.local_block(t["gids"], nodes), 4, op="mean")}
    return {k: v.numpy() for k, v in out.items()}


def _rm2_state(cell, params_np):
    from repro_torch.models.convert import dlrm_params_from_numpy, local_blocks
    from repro_torch.optim import adamw_init
    params = dlrm_params_from_numpy(params_np, cell.meta["cfg"], device="cpu")
    return local_blocks({"params": params, "opt": adamw_init(params)},
                        cell.in_shardings[0])


def rm2_case(mesh, p, first):
    """dlrm-rm2's smoke train cell under ``rules_recsys``: loss and
    gradients at the payload's parameters (``dlrm_value_and_grad``), then
    STEPS steps on the cell's batch; the table's blocks joined whole."""
    from repro_torch import shardlib as sl
    from repro_torch.launch import steps
    with sl.axis_rules(mesh, steps.rules_for("dlrm-rm2", "train_batch",
                                             mesh)):
        cell = steps.build_cell("dlrm-rm2", "train_batch", smoke=True,
                                device="cpu")
        state = _rm2_state(cell, p["rm2"])
        batch = cell.args[1:]
        loss, grads = steps.dlrm_value_and_grad(state["params"], *batch,
                                                cell.meta["cfg"])
        losses, gnorms = [], []
        for _ in range(STEPS):
            _, m = cell.fn(state, *batch)
            losses.append(m["loss"].item())
            gnorms.append(m["gnorm"].item())
        spec = cell.in_shardings[0]["params"]["tables"].spec
        whole = {"grads": grads, "params": state["params"],
                 "m": state["opt"].m, "v": state["opt"].v}
        for tree in whole.values():
            tree["tables"] = sl.gather_blocks(tree["tables"], spec)
    out = {"loss0": loss.item(), "losses": losses, "gnorms": gnorms,
           "rows": cell.args[0]["params"]["tables"].shape[1],
           "batch": batch[0].shape[0], "count": int(state["opt"].count)}
    if first:
        out.update({k: _np_leaves(t) for k, t in whole.items()})
    return out


def cell_step_case(mesh, arch, shape):
    """One step of ``arch``'s smoke ``shape`` cell as ``build_cell``
    makes it under its rules: the loss."""
    from repro_torch import shardlib as sl
    from repro_torch.launch import steps
    with sl.axis_rules(mesh, steps.rules_for(arch, shape, mesh)):
        cell = steps.build_cell(arch, shape, smoke=True, device="cpu")
        _, m = cell.run()
    return m["loss"].item()


def train_battery(rank, world, p):
    """The payload's schedule on this rank: ``p["stages"]`` is a list of
    stages, each a list of ``(mesh shape, ranks, cases)``; a case is
    ``("gnn", arch, shape, variant)``, ``("dst_ranged",)``,
    ``("prims",)``, ``("rm2",)`` or ``("step", arch, shape)``.  Returns ``{(shape,
    ranks, i): result}`` for the cases of this rank's meshes."""
    from repro_torch import shardlib as sl
    meshes = {}
    for stage in p["stages"]:
        for shape, ranks, _ in stage:
            meshes[shape, ranks] = sl.make_mesh(shape, ("data", "model"),
                                                "cpu", ranks=ranks)
    out = {}
    for stage in p["stages"]:
        for shape, ranks, cases in stage:
            mesh = meshes[shape, ranks]
            if mesh is None:
                continue
            first = rank == ranks[0]
            for i, case in enumerate(cases):
                if case[0] == "gnn":
                    res = gnn_case(mesh, p, *case[1:], first)
                elif case[0] == "dst_ranged":
                    res = dst_ranged_case(mesh, p, first)
                elif case[0] == "prims":
                    res = prims_case(mesh, p)
                elif case[0] == "rm2":
                    res = rm2_case(mesh, p, first)
                else:
                    res = cell_step_case(mesh, *case[1:])
                out[shape, ranks, i] = res
    return out


def params_np(arch, shape):
    """The port's smoke cell's parameters (seed 0) as a numpy tree: a
    GNN's as its cell draws them; rm2's by the sequential law from seed
    0 (``init_params(cfg, generator)``), the weights its cell held
    before the cells took the keyed draw, on which these tests' bounds
    were set."""
    import torch

    from repro_torch.launch import steps
    from repro_torch.models import dlrm
    from repro_torch.tree import map_tree
    cell = steps.build_cell(arch, shape, smoke=True, device="cpu")
    params = cell.args[0]["params"]
    if arch == "dlrm-rm2":
        params = dlrm.init_params(cell.meta["cfg"],
                                  torch.Generator().manual_seed(0), "cpu")
    return map_tree(lambda t: t.numpy().copy(), params)


def unsharded_first_loss(arch, shape):
    """The first step's loss of the port's unsharded smoke cell."""
    from repro_torch.launch import steps
    cell = steps.build_cell(arch, shape, smoke=True, device="cpu")
    return cell.run()[1]["loss"].item()
