"""The closeness tests' index and engines (``tests/test_torch_closeness_
{memory,raw,delta}.py``): the port's closeness application (the paper's
Table 5) against the JAX package's.

``estimate_closeness`` and ``topk_closeness`` over the port's engines
must give the JAX package's nodes, farness, closeness, batch counts and
prune counts exactly: in memory (full sweeps) and from raw and delta
stores, where ``topk_closeness`` runs the bounded sweeps
(``ssd_bounded``) and abandons batches mid-sweep.  The cases are split
by where the index lives, one file each, so that the test runner's
``--dist loadfile`` spreads them over workers; most of a case's time is
the JAX engine's own work, not its compiles.
"""
import io

import numpy as np

import repro.core as J
import repro.storage as JSt
import repro_torch.core as T
import repro_torch.storage as TSt

GRAPHS = ("road", "gnm")
ESTIMATE_CASES = [(0.5, 8, None), (0.3, 16, None), (0.1, 32, 37)]
TOPK_CASES = [(1, 4, None), (5, 8, None), (10, 16, 60), (3, 32, 40),
              (4, 1, 50), (3, 2, 90)]


def build(root, codecs):
    """{graph: (JAX index, the port's index, {codec: store path})} of a
    road grid and of a weighted random digraph, written by the JAX
    package; a store for each of ``codecs`` under ``root``."""
    out = {}
    for name, g in (("road", J.grid_road_graph(11, seed=3)),
                    ("gnm", J.gnm_random_digraph(150, 600, seed=4,
                                                 weighted=True))):
        res = J.build_hod(g, J.BuildConfig(max_core_nodes=32,
                                           max_core_edges=1024, seed=0))
        ixj = J.pack_index(g, res, chunk=64)
        stores = {}
        for codec in codecs:
            stores[codec] = str(root / f"{name}_{codec}")
            ixj.save_store(stores[codec], block_bytes=1024, codec=codec)
        buf = io.BytesIO()
        ixj.save(buf)
        buf.seek(0)
        with np.load(buf) as z:
            out[name] = (ixj, T.index_from_numpy(z), stores)
    return out


def engines(ix, graph, where):
    """(port engine, JAX engine) in memory or over one store."""
    ixj, ixt, stores = ix[graph]
    if where == "memory":
        return T.QueryEngine(ixt, device="cpu"), J.QueryEngine(ixj)
    path = stores[where]
    budget = int(0.25 * TSt.segment_logical_bytes(path))
    return (TSt.StreamingQueryEngine(
                TSt.IndexStore(path, cache=TSt.PageCache(budget)),
                device="cpu"),
            JSt.StreamingQueryEngine(
                JSt.IndexStore(path, cache=JSt.PageCache(budget))))


def close(*engs):
    for e in engs:
        if hasattr(e, "store"):
            e.close()


def check_estimate(ix, graph, where, eps, batch, k_override):
    te, je = engines(ix, graph, where)
    try:
        got = T.estimate_closeness(te, eps=eps, batch_size=batch, seed=3,
                                   k_override=k_override)
        want = J.estimate_closeness(je, eps=eps, batch_size=batch, seed=3,
                                    k_override=k_override)
    finally:
        close(te, je)
    assert (got.k, got.batches) == (want.k, want.batches)
    assert got.batches == -(-got.k // batch)
    np.testing.assert_array_equal(got.closeness, want.closeness)
    assert got.closeness.dtype == want.closeness.dtype
    assert np.all(got.closeness >= 0) and np.any(got.closeness > 0)


def check_topk(ix, graph, where, k, batch, n_cand):
    n = ix[graph][1].n
    cand = (None if n_cand is None else
            np.random.default_rng(k).choice(n, n_cand, replace=False))
    te, je = engines(ix, graph, where)
    try:
        got = T.topk_closeness(te, k=k, candidates=cand, batch_size=batch,
                               seed=1)
        want = J.topk_closeness(je, k=k, candidates=cand,
                                batch_size=batch, seed=1)
    finally:
        close(te, je)
    np.testing.assert_array_equal(got.nodes, want.nodes)
    np.testing.assert_array_equal(got.farness, want.farness)
    np.testing.assert_array_equal(got.closeness, want.closeness)
    assert (got.k, got.batches, got.pruned) == \
        (want.k, want.batches, want.pruned)
    if where == "memory":
        assert got.pruned == 0


def check_store_prunes(ix, where):
    """The bounded sweeps find the in-memory top-k, abandoning some
    batches (and their remaining level reads) on the way."""
    mem = T.QueryEngine(ix["gnm"][1], device="cpu")
    want = T.topk_closeness(mem, k=4, batch_size=2)
    te, je = engines(ix, "gnm", where)
    try:
        got = T.topk_closeness(te, k=4, batch_size=2)
    finally:
        close(te, je)
    np.testing.assert_array_equal(got.nodes, want.nodes)
    np.testing.assert_array_equal(got.farness, want.farness)
    assert got.pruned > 0 and want.pruned == 0
    assert got.batches == want.batches
    # the exact farness: finite out-distances summed
    d = mem.ssd(want.nodes)
    np.testing.assert_array_equal(
        want.farness, np.where(np.isfinite(d), d, 0.0).sum(axis=1))
