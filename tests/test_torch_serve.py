"""The port's QueryServer against the JAX package's, on the same index.

Same request stream (with repeats and a ragged last batch) through both
servers: the same answers, cache hits, batches, padded slots and modeled
I/O, in every in-memory query mode.
"""
import dataclasses
import io

import numpy as np
import pytest

import repro.core as J
import repro_torch.core as T
from repro.core.build_fast import build_hod_fast as jax_build_hod_fast
from repro.launch.serve import QueryServer as JaxQueryServer
from repro_torch.launch.serve import QueryServer, main

_IX = {}


def indexes():
    """(JAX index, the port's index) of one small road grid."""
    if not _IX:
        g = J.grid_road_graph(9, seed=2)
        res = jax_build_hod_fast(g, J.BuildConfig(max_core_nodes=24,
                                                  max_core_edges=512))
        ixj = J.pack_index(g, res, chunk=64)
        buf = io.BytesIO()
        ixj.save(buf)
        buf.seek(0)
        with np.load(buf) as z:
            _IX["ix"] = (ixj, T.index_from_numpy(z))
    return _IX["ix"]


def _stream(n, mode, seed=0):
    rng = np.random.default_rng(seed)
    pool = rng.choice(n, size=12, replace=False)
    if mode == "p2p":
        pairs = np.stack([pool, np.roll(pool, 3)], axis=1)
        return pairs[rng.integers(0, len(pairs), 29)].astype(np.int32)
    return rng.choice(pool, size=29).astype(np.int32)


@pytest.mark.parametrize("mode", ["ssd", "sssp", "p2p", "within", "knn"])
def test_server_matches_jax(mode):
    ixj, ixt = indexes()
    kw = dict(batch_size=8, cache_entries=9, mode=mode, within_d=7.0,
              knn_k=5, warm_start=True)
    sj = JaxQueryServer(J.QueryEngine(ixj), **kw)
    st = QueryServer(T.QueryEngine(ixt, device="cpu"), **kw)
    reqs = _stream(ixt.n, mode)
    rj, rt = sj.serve_stream(reqs), st.serve_stream(reqs)
    assert len(rj) == len(rt) == len(reqs)
    for a, b in zip(rj, rt):
        assert (a.source, a.target, a.cached, a.batched_with, a.mode) == \
            (b.source, b.target, b.cached, b.batched_with, b.mode)
        assert a.io_bytes == b.io_bytes
        for f in ("dist", "pred", "nodes"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                np.testing.assert_array_equal(x, y)
    for f in ("requests", "batches", "cache_hits", "padded_slots"):
        assert getattr(st.stats, f) == getattr(sj.stats, f), f
    assert st.stats.cache_hits > 0 and st.stats.padded_slots > 0
    assert st.modeled_scan_bytes == sj.modeled_scan_bytes
    assert dataclasses.astuple(st.modeled_io()) == \
        dataclasses.astuple(sj.modeled_io())
    for name in ("server.requests", "server.batches", "server.padded_slots",
                 "server.result_cache_hits"):
        assert st.metrics.counter(name).value == \
            sj.metrics.counter(name).value, name


def test_cache_smaller_than_a_chunk():
    """A hit that the same chunk's misses evict is still answered (the
    JAX server raises TypeError here: it reads the hit back from the
    cache after the misses were inserted)."""
    _, ixt = indexes()
    eng = T.QueryEngine(ixt, device="cpu")
    server = QueryServer(eng, batch_size=4, cache_entries=2)
    reqs = np.array([3, 4, 9, 9, 3, 4, 5, 6], np.int32)   # 4 hits, evicted
    out = server.serve_stream(reqs)
    assert server.stats.cache_hits > 0
    want = eng.ssd(reqs)
    for i, r in enumerate(out):
        np.testing.assert_array_equal(r.dist, want[i])


def test_server_rejects_bad_arguments():
    _, ixt = indexes()
    eng = T.QueryEngine(ixt, device="cpu")
    for kw in (dict(batch_size=0), dict(cache_entries=-1),
               dict(mode="topk"), dict(within_d=0.0), dict(knn_k=0)):
        with pytest.raises(ValueError):
            QueryServer(eng, **kw)
    with pytest.raises(ValueError, match="p2p"):
        QueryServer(eng, mode="p2p").serve_stream(np.array([1, 2]))


@pytest.mark.parametrize("mode", ["ssd", "p2p"])
def test_cli_serves_on_cpu(capsys, mode):
    main(["--side", "7", "--requests", "20", "--batch", "4",
          "--mode", mode, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 20" in out and "engine: cpu" in out
