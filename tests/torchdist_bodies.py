"""Rank-side bodies of the port's distributed tests (``torchdist.
run_ranks``).  This module imports the port and torch only, never JAX:
every rank imports it.  Each body returns plain Python and numpy
values, which the parent compares with the JAX package and with the
port's unsharded functions.  The ``*_cases`` functions are the same
calls without a mesh, for the parent's unsharded references.

One spawn of 4 ranks serves the world sizes 4, 3 and 2 (:func:`worlds`):
every rank makes every world's mesh over the first w ranks (a gloo
group each), then the worlds run largest first, each on its own ranks,
so no rank waits in a collective on another's earlier world.  A body
returns ``{w: results}`` for the worlds its rank belongs to.
"""
import asyncio
import dataclasses
import types

import numpy as np
import torch

# ---------------------------------------------------------------------------
# shardlib: collectives, blocks, the survivors' mesh, compressed_mean
# ---------------------------------------------------------------------------

#: Mesh shapes over ("data", "model") a world size runs.
SHARDLIB_MESHES = {2: [(1, 2), (2, 1)], 3: [(1, 3)], 4: [(2, 2), (1, 4)]}


def worlds(world):
    """The world sizes a spawn of ``world`` ranks runs, largest first."""
    return tuple(range(world, 1, -1)) if world > 1 else (1,)


AXES = (("data",), ("model",), ("data", "model"), ("model", "data"))


def shardlib_x(rank):
    """The rank's operand of the reductions and gathers."""
    return (np.arange(6, dtype=np.float32).reshape(2, 3) * (rank + 1)
            + 10 * rank)


def shardlib_battery(rank, world, p):
    from repro_torch import shardlib as sl
    from repro_torch.ft import surviving_mesh
    ws = worlds(world)
    meshes = {(w, shape): sl.make_mesh(shape, ("data", "model"), "cpu",
                                       ranks=range(w))
              for w in ws for shape in SHARDLIB_MESHES[w]}
    data = {w: sl.make_mesh((w,), ("data",), "cpu", ranks=range(w))
            for w in ws}
    out = {w: {} for w in ws if rank < w}
    for (w, shape), mesh in meshes.items():
        if mesh is not None:
            out[w][shape] = _collectives(mesh, rank)
    for w, mesh in data.items():
        if mesh is not None:
            out[w].update(_compressed(mesh.get_group("data"), rank, p))
    # survivors at model parallelism 2: the first 2 re-form (1, 2)
    for n in (2, 3):
        mesh = surviving_mesh(n, model_parallelism=2, device_type="cpu")
        out["surv", n] = None
        if mesh is not None:
            with sl.axis_rules(mesh, {}):
                s = sl.psum(torch.tensor([float(rank)]), ("model",))
            out["surv", n] = (tuple(mesh.shape),
                              tuple(mesh.get_coordinate()), float(s))
    try:
        surviving_mesh(1, model_parallelism=2, device_type="cpu")
        out["surv_one"] = "no error"
    except RuntimeError as exc:
        out["surv_one"] = str(exc)
    return out


def _collectives(mesh, rank):
    """Every helper of shardlib over each axis tuple of ``mesh``."""
    from repro_torch import shardlib as sl
    r = {}
    rules = {"batch": "data", "rows": "model", "nodes": ("data", "model")}
    with sl.axis_rules(mesh, rules):
        x = torch.from_numpy(shardlib_x(rank))
        for axes in AXES:
            k = "+".join(axes)
            n = sl.axis_size(axes)
            r["index", k] = sl.axis_index(axes)
            r["size", k] = n
            r["psum", k] = sl.psum(x, axes).numpy()
            r["pmax", k] = sl.pmax(x, axes).numpy()
            r["pmin", k] = sl.pmin(x, axes).numpy()
            r["gather0", k] = sl.all_gather(x, axes, axis=0).numpy()
            r["gather1", k] = sl.all_gather(x, axes, axis=1).numpy()
            y = torch.arange(4 * n, dtype=torch.float32) * (rank + 1)
            r["scatter", k] = sl.psum_scatter(y, axes).numpy()
        r["identity"] = sl.psum(x, ()) is x and sl.all_gather(x, ()) is x
        r.update(_backward(rank, x))
        g = torch.arange(4 * 12, dtype=torch.float32).reshape(4, 12)
        for spec in (sl.P("data", "model"), sl.P(None, ("data", "model")),
                     sl.P(None, ("model", "data"))):
            blk = sl.local_block(g, spec)
            r["block", spec] = blk.numpy()
            r["roundtrip", spec] = sl.gather_blocks(blk, spec).numpy()
        r["spec"] = tuple(sl.logical_to_spec("batch", "rows", "nodes"))
        try:
            sl.maybe_shard_map(lambda a: a, (sl.P("pod"),), sl.P())(x)
            r["bad_spec"] = False
        except ValueError:
            r["bad_spec"] = True
    return r


def shardlib_cot(rank, shape):
    """The rank's cotangent of a collective's output of ``shape``."""
    n = int(np.prod(shape))
    return (np.arange(n, dtype=np.float32).reshape(shape) * 0.5
            - 3.0 * rank)


def _backward(rank, x):
    """The gradient each autograd collective gives ``x`` under the
    rank's cotangent (:func:`shardlib_cot`), over each axis tuple.  Each
    backward runs in a thread of its own, which sees no axis rules (as
    autograd's device thread on a card does); ``ckpt`` recomputes a
    gather there (``torch.utils.checkpoint`` of a function that keeps
    the rules, ``shardlib.under_current_rules``)."""
    import threading

    from torch.utils.checkpoint import checkpoint

    from repro_torch import shardlib as sl
    r = {}
    for axes in AXES:
        k = "+".join(axes)
        twice = sl.under_current_rules(
            lambda a: sl.all_gather(a * 2.0, axes, axis=0))
        ops = {"ckpt": lambda a: checkpoint(twice, a, use_reentrant=False),
               "gather0": lambda a: sl.all_gather(a, axes, axis=0),
               "gather1": lambda a: sl.all_gather(a, axes, axis=1),
               # tile j of the scattered operand is (j + 1) a: its
               # cotangent must come from the member of axis_index j
               "scatter": lambda a: sl.psum_scatter(torch.cat(
                   [a.reshape(-1) * (j + 1)
                    for j in range(sl.axis_size(axes))]), axes),
               "psum": lambda a: sl.psum(a, axes),
               "enter": lambda a: sl.enter(a, axes)}
        for name, op in ops.items():
            a = x.clone().requires_grad_(True)
            y = op(a)
            cot = torch.from_numpy(shardlib_cot(rank, tuple(y.shape)))
            t = threading.Thread(target=y.backward, args=(cot,))
            t.start()
            t.join()
            r["bwd", name, k] = None if a.grad is None else a.grad.numpy()
    return r


def _compressed(group, rank, p):
    """``compressed_mean`` of the rank's gradients over ``group``."""
    from repro_torch.optim.compress import compressed_mean
    grads = {k: torch.from_numpy(a) for k, a in p["grads"][rank].items()}
    noise = [torch.from_numpy(p["noise"][rank][k]) for k in sorted(grads)]
    return {"none": {k: v.numpy() for k, v in compressed_mean(
                grads, group=group, scheme="none").items()},
            "int8": {k: v.numpy() for k, v in compressed_mean(
                grads, noise, group=group, scheme="int8").items()}}


# ---------------------------------------------------------------------------
# The HoD batch split
# ---------------------------------------------------------------------------

def _stats(engine):
    """(cache, I/O) counters of a store engine, as dicts."""
    return (dataclasses.asdict(engine.store.cache.stats.snapshot()),
            dataclasses.asdict(engine.store.device.stats))


def _engine_calls(engine, p, store):
    """Every public query of ``engine`` on the payload's batch (and the
    store's counters after each, for a store engine).  A store engine at
    queue depth 1 runs the full sweeps only: the bounded sweeps read
    synchronously at every depth (no pipeline), so depth 4 covers them."""
    from repro_torch.core.closeness import topk_closeness
    src, tgt = p["src"], p["tgt"]
    calls = [("ssd", lambda: engine.ssd(src)),
             ("sssp", lambda: engine.sssp(src))]
    bounded = not store or store[1] != 1
    if bounded:
        calls += [("p2p", lambda: engine.p2p(src, tgt)),
                  ("within", lambda: engine.ssd_within(src, p["d"])),
                  ("knn", lambda: engine.knn(src, p["k"]))]
    if store and bounded:
        calls += [(f"bounded{t}",
                   lambda t=t: engine.ssd_bounded(p["bounded_src"], t))
                  for t in p["thresholds"]]
    if store == p["topk_store"] or not store:
        calls.append(("topk", lambda: dataclasses.astuple(topk_closeness(
            engine, k=p["topk_k"], candidates=p["topk_cand"],
            batch_size=p["batch"]))))
    out = {}
    for name, call in calls:
        got = call()
        if name == "topk":      # query_seconds is a time
            got = got[:4] + got[5:]
        out[name] = got
        if store:
            out[name, "stats"] = _stats(engine)
    return out


def hod_cases(p):
    """Every engine and server case of the HoD split on this process,
    under whatever axis rules are current."""
    from repro_torch import core as T
    from repro_torch import storage as TS
    with np.load(p["npz"]) as z:
        ix = T.index_from_numpy(z)
    engine = T.QueryEngine(ix, device="cpu")
    out = {"memory": _engine_calls(engine, p, None)}
    for codec, path in p["stores"].items():
        budget = int(0.25 * TS.segment_logical_bytes(path))
        for depth in (1, 4):
            eng = TS.StreamingQueryEngine(
                TS.IndexStore(path, cache=TS.PageCache(budget,
                                                       policy="2q")),
                queue_depth=depth, device="cpu")
            try:
                out[codec, depth] = _engine_calls(eng, p, (codec, depth))
            finally:
                eng.close()
    out["stream"] = _serve_stream(engine, p)
    for scheduler in ("fifo", "slo"):
        out["async", scheduler] = _serve_async(engine, p, scheduler)
    return out


def _result_rows(results):
    return [(r.mode, r.source, r.target, r.cached, r.batched_with,
             r.io_bytes, r.dist, r.pred, r.nodes) for r in results]


def _server_counts(server):
    st = server.stats
    counters = server.metrics.snapshot()["counters"]
    return ((st.requests, st.cache_hits, st.padded_slots, st.batches),
            {k: v for k, v in counters.items()
             if k.startswith(("server.batches", "slo.requests",
                              "server.padded_slots", "server.requests",
                              "server.result_cache_hits"))})


def _serve_stream(engine, p):
    from repro_torch.launch.serve import QueryServer
    server = QueryServer(engine, batch_size=p["batch"], cache_entries=24)
    server.warmup()
    rows = _result_rows(server.serve_stream(p["requests"]))
    return rows, _server_counts(server)


def _serve_async(engine, p, scheduler):
    """The scheduler tests' mixed stream, submitted in chunks of 7 and
    drained on a frozen clock (only size triggers and the drain flush)."""
    from repro_torch.config import SERVE_DEFAULTS, Config
    from repro_torch.launch.serve import server_from_config
    over = {"serve": dict(p["mix"], scheduler=scheduler)}
    server = server_from_config(
        Config(None, defaults=SERVE_DEFAULTS, overrides=over),
        engine=engine)
    server.warmup()
    clock = types.SimpleNamespace(t=0.0)
    server._now = lambda: clock.t
    stream = p["mixed"]

    async def drive():
        tasks = []
        for lo in range(0, len(stream), 7):
            tasks += [asyncio.create_task(server.submit(*a, mode=m))
                      for m, a in stream[lo:lo + 7]]
            await asyncio.sleep(0)
        await server.drain()
        return await asyncio.gather(*tasks)
    return _result_rows(asyncio.run(drive())), _server_counts(server)


def hod_battery(rank, world, p):
    """Every HoD case on this rank of a ``("data",)`` mesh of ``world``
    ranks; a world of one also gives the unsharded port's results (no
    axis rules) under ``"ref"``."""
    from repro_torch import shardlib as sl
    mesh = sl.make_mesh((world,), ("data",), "cpu")
    with sl.axis_rules(mesh, {"batch": "data"}):
        out = {world: hod_cases(p)}
    if world == 1:
        out["ref"] = hod_cases(p)
    return out


# ---------------------------------------------------------------------------
# The sharded model branches
# ---------------------------------------------------------------------------

def models_cases(p, mesh=None):
    """The mapped branches on this rank's blocks under ``mesh`` (a ``(1,
    w)`` smoke mesh) and each family's rules, or the unmapped functions
    on the whole inputs (no mesh); every result gathered to the
    whole."""
    import contextlib

    from repro_torch import shardlib as sl
    from repro_torch.launch import mesh as M
    from repro_torch.models import dlrm
    from repro_torch.models.gnn.common import partitioned_aggregate, take
    from repro_torch.models.layers import (MoEConfig, attention_decode,
                                           moe_block)
    t = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
         for k, v in p.items()}
    mapped = mesh is not None

    def ruled(rules, *args):
        return (sl.axis_rules(mesh, rules(mesh, *args)) if mapped
                else contextlib.nullcontext())

    def cut(x, *names):
        return sl.local_block(x, sl.logical_to_spec(*names)) if mapped \
            else x

    def whole(x, *names):
        return sl.gather_blocks(x, sl.logical_to_spec(*names)) if mapped \
            else x

    out = {}
    b = p["q"].shape[0]
    kv = ("batch", "kv_seq", None, None)
    rep = ("batch", None, None)
    for name, window, curs in (("full", None, p["curs_full"]),
                               ("rolling", p["window"], p["curs_roll"])):
        with ruled(M.rules_serve_lm, b):
            kl = cut(t[f"kc_{name}"].clone(), *kv)
            vl = cut(t[f"vc_{name}"].clone(), *kv)
            for cur in curs:
                o, kl, vl = attention_decode(
                    cut(t["q"], *rep), kl, vl, cut(t["kn"], *rep),
                    cut(t["vn"], *rep), cur, window=window)
                out["decode", name, cur] = whole(o, *rep).numpy()
            out["decode", name, "k"] = whole(kl, *kv).numpy()
            out["decode", name, "v"] = whole(vl, *kv).numpy()
    e, d, f = p["wg"].shape
    for cf in (1.25, 0.5):
        cfg = MoEConfig(n_experts=e, top_k=2, d_ff=f, capacity_factor=cf)
        with ruled(M.rules_train_lm):
            ew = ("expert", None, None)
            y, aux = moe_block(cut(t["x"], *rep), t["router"],
                               cut(t["wg"], *ew), cut(t["wu"], *ew),
                               cut(t["wd"], *ew), cfg)
            out["moe", cf] = (whole(y, *rep).numpy(), float(aux))
    with ruled(M.rules_recsys, p["ids"].shape[0]):
        tab = cut(t["tables"], None, "rows", None)
        out["lookup"] = whole(dlrm.embedding_lookup(
            tab, cut(t["ids"], "batch", None)), "batch", None, None).numpy()
        params = {"tables": tab, "bot": [[t[f"bw{i}"], t[f"bb{i}"]]
                                         for i in range(p["n_bot"])]}
        cfg = dlrm.DLRMConfig(n_dense=p["dense"].shape[1],
                              n_sparse=p["tables"].shape[0],
                              embed_dim=p["tables"].shape[2],
                              vocab_per_table=p["tables"].shape[1],
                              bot_mlp=p["bot_mlp"], top_mlp=(1,))
        for top_k in (8, 1000):
            vals, ids = dlrm.retrieval_scores(
                params, t["dense"], t["ids"][:1], cut(t["cand"], "batch"),
                cfg, top_k=top_k)
            out["retrieval", top_k] = (vals.numpy(), ids.numpy())
    with ruled(M.rules_gnn):
        x = cut(t["feat"], "nodes", None)
        arrays = tuple(cut(t[k], "edges") for k in ("src", "dst", "coef"))
        for chunks in (1, 3):
            agg = partitioned_aggregate(
                x, arrays, lambda xf, s, d, c: (take(xf, s) * c[:, None], d),
                p["n_nodes"], x.shape[1:], x.dtype, n_chunks=chunks)
            out["aggregate", chunks] = whole(agg, "nodes", None).numpy()
    return out


def models_battery(rank, world, p):
    """``p["by_world"][w]``'s cases on the ``(1, w)`` smoke mesh of the
    first w ranks (``launch.mesh.make_smoke_mesh``'s shape)."""
    from repro_torch import shardlib as sl
    from repro_torch.launch import steps
    meshes = {w: sl.make_mesh((1, w), ("data", "model"), "cpu",
                              ranks=range(w)) for w in worlds(world)}
    out = {}
    for w, mesh in meshes.items():
        if mesh is None:
            continue
        pw = p["by_world"][w]
        r = out[w] = models_cases(pw, mesh)
        if w in (2, 4):      # rm2's smoke tables split over 2 and 4 ranks
            with sl.axis_rules(mesh, steps.rules_for(
                    "dlrm-rm2", "serve_p99", mesh)):
                cell = steps.build_cell("dlrm-rm2", "serve_p99",
                                        smoke=True, device="cpu")
                r["rm2_serve"] = cell.run().numpy()
        if w == 2:              # both ranks run the cells
            trees = _sharding_trees(mesh)
            if rank == 0:
                r["trees"] = trees
        r["convert"] = _converted_blocks(mesh, pw)
    return out


def _converted_blocks(mesh, p):
    """``models/convert.py``'s ``local_blocks`` of converted parameters
    under ``rules_recsys``: the rank's row block of the tables (MLPs
    whole)."""
    from repro_torch import shardlib as sl
    from repro_torch.launch.mesh import rules_recsys
    from repro_torch.launch.steps import _resolve
    from repro_torch.models import convert, dlrm
    cfg = dlrm.DLRMConfig(n_dense=5, n_sparse=4, embed_dim=8,
                          vocab_per_table=48, bot_mlp=p["bot_mlp"],
                          top_mlp=(1,))
    tree = {"tables": p["tables"],
            "bot": [[p[f"bw{i}"], p[f"bb{i}"]] for i in range(p["n_bot"])],
            "top": [[p["bw0"], p["bb0"]]]}
    params = convert.dlrm_params_from_numpy(tree, cfg, device="cpu")
    with sl.axis_rules(mesh, rules_recsys(mesh, 6)):
        got = convert.local_blocks(
            params, _resolve(dlrm.param_shardings(cfg)))
    return got["tables"].numpy(), got["bot"][0][0].numpy()


def _sharding_trees(mesh):
    """The JAX ``test_cells_have_consistent_sharding_trees`` on smoke
    cells: leaves of args and of in_shardings align (a graph batch's
    leaves are its tensors), each spec fits its tensor; and whether each
    cell runs on this mesh under its rules."""
    from repro_torch import shardlib as sl
    from repro_torch.launch import steps
    from repro_torch.tree import leaves
    out = {}
    for arch, shape in [("glm4-9b", "train_4k"),
                        ("qwen3-moe-30b-a3b", "decode_32k"),
                        ("gcn-cora", "ogb_products"),
                        ("dlrm-rm2", "retrieval_cand")]:
        rules = steps.rules_for(arch, shape, mesh)
        with sl.axis_rules(mesh, rules):
            cell = steps.build_cell(arch, shape, smoke=True, device="cpu")
        a_leaves = leaves(cell.args)
        s_leaves = leaves(cell.in_shardings)
        fits = len(a_leaves) == len(s_leaves)
        for a, s in zip(a_leaves, s_leaves):
            if isinstance(a, torch.Tensor):
                fits &= isinstance(s, sl.NamedSharding) \
                    and len(s.spec) <= a.dim()
        try:
            with sl.axis_rules(mesh, rules):
                cell.run()
            runs = True
        except NotImplementedError:
            runs = False
        out[arch, shape] = (len(a_leaves), len(s_leaves), bool(fits), runs)
    return out
