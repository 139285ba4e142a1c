"""The port's store-backed engine and server against the JAX package's.

The port's ``StreamingQueryEngine`` (on the CPU, plain-torch level
bodies and the kernels' plain versions) must answer bit-identically
(``assert_array_equal``) to the JAX package's ``StreamingQueryEngine``
and to both in-memory engines, on every public method and in all three
core modes; the JAX streaming engine also runs once with Pallas in
interpret mode.  Every operation on the path is an fp32 add, a min or a
max, so an equal input gives an equal output.  The serve CLI's
``--store`` path reports the server's own page-cache numbers.
"""
import io
import os
import re

import numpy as np
import pytest

import repro.core as J
import repro.storage as JS
import repro_torch.core as T
import repro_torch.storage as TS
from repro_torch.launch import serve as tserve

MODES = ("closure", "bellman", "dijkstra")
SRC = np.array([0, 3, 77, 149, 3, 60], np.int32)
TGT = np.array([5, 140, 0, 60, 99, 60], np.int32)
_ENGINES = {}


@pytest.fixture(scope="module")
def store_dir(tmp_path_factory):
    """A raw store of the JAX storage tests' index, written by the JAX
    package; the port's in-memory engine reads the same index."""
    g = J.gnm_random_digraph(150, 600, seed=4, weighted=True)
    res = J.build_hod(g, J.BuildConfig(max_core_nodes=32,
                                       max_core_edges=1024, seed=0))
    ixj = J.pack_index(g, res, chunk=64)
    path = str(tmp_path_factory.mktemp("stream") / "store")
    ixj.save_store(path, block_bytes=1024)
    buf = io.BytesIO()
    ixj.save(buf)
    buf.seek(0)
    with np.load(buf) as z:
        ixt = T.index_from_numpy(z)
    _ENGINES.clear()
    yield path, ixj, ixt
    for engines in _ENGINES.values():
        for e in engines[:2]:
            e.close()
    _ENGINES.clear()


def engines(store, mode):
    """(port streaming, JAX streaming, port in-memory, JAX in-memory)
    in ``mode``, the streaming ones behind a 5% page cache."""
    if mode not in _ENGINES:
        path, ixj, ixt = store
        budget = int(0.05 * TS.segment_logical_bytes(path))
        ts = TS.StreamingQueryEngine(
            TS.IndexStore(path, cache=TS.PageCache(budget, policy="2q")),
            core_mode=mode, device="cpu")
        js = JS.StreamingQueryEngine(
            JS.IndexStore(path, cache=JS.PageCache(budget, policy="2q")),
            core_mode=mode)
        _ENGINES[mode] = (ts, js, T.QueryEngine(ixt, core_mode=mode,
                                                device="cpu"),
                          J.QueryEngine(ixj, core_mode=mode))
    return _ENGINES[mode]


def _all_equal(outs):
    for got in outs[1:]:
        if isinstance(got, tuple):
            for a, b in zip(got, outs[0]):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(got, outs[0])


@pytest.mark.parametrize("mode", MODES)
def test_ssd(store_dir, mode):
    es = engines(store_dir, mode)
    assert es[0].core_mode == es[1].core_mode
    _all_equal([e.ssd(SRC) for e in es])


@pytest.mark.parametrize("mode", MODES)
def test_sssp(store_dir, mode):
    es = engines(store_dir, mode)
    outs = [e.sssp(SRC) for e in es]
    _all_equal(outs)
    np.testing.assert_array_equal(outs[0][0], es[2].ssd(SRC))


@pytest.mark.parametrize("early_term", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_p2p(store_dir, mode, early_term):
    ts, js, tm, jm = engines(store_dir, mode)
    _all_equal([ts.p2p(SRC, TGT, early_term=early_term),
                js.p2p(SRC, TGT, early_term=early_term),
                tm.p2p(SRC, TGT), jm.p2p(SRC, TGT)])


@pytest.mark.parametrize("d", [0.0, 6.0, 25.5])
@pytest.mark.parametrize("mode", MODES)
def test_ssd_within(store_dir, mode, d):
    _all_equal([e.ssd_within(SRC, d) for e in engines(store_dir, mode)])


@pytest.mark.parametrize("k", [1, 5, 150])
@pytest.mark.parametrize("mode", MODES)
def test_knn(store_dir, mode, k):
    _all_equal([e.knn(SRC, k) for e in engines(store_dir, mode)])


@pytest.mark.parametrize("mode", MODES)
def test_ssd_bounded(store_dir, mode):
    """Completed sweeps equal SSD; a prune happens where the reference
    prunes, and only where every source's farness exceeds the bound."""
    ts, js, tm, _ = engines(store_dir, mode)
    src = SRC[[0, 2, 3, 5]]                 # sources that reach others
    full = tm.ssd(src)
    farness = np.where(np.isfinite(full), full, 0.0).sum(axis=1)
    done = []
    for threshold in (float("inf"), float(np.median(farness)), 30.0, 0.0):
        got, want = (e.ssd_bounded(src, threshold) for e in (ts, js))
        assert got[1] == want[1]
        done.append(got[1])
        if got[1]:
            np.testing.assert_array_equal(got[0], full)
            np.testing.assert_array_equal(got[0], want[0])
        else:
            assert got[0] is None and np.all(farness > threshold)
    assert done[0] and not done[-1]         # both outcomes exercised


def test_matches_the_pallas_streaming_engine(store_dir):
    """The JAX streaming engine with its Pallas kernel (interpret mode)."""
    path = store_dir[0]
    js = JS.StreamingQueryEngine(JS.IndexStore(path), use_pallas=True,
                                 interpret=True, prefetch=False)
    try:
        ts = engines(store_dir, "closure")[0]
        _all_equal([ts.ssd(SRC[:3]), js.ssd(SRC[:3])])
        _all_equal([ts.sssp(SRC[:3]), js.sssp(SRC[:3])])
    finally:
        js.close()


def test_depths_and_sync_answer_alike(store_dir):
    path = store_dir[0]
    want = engines(store_dir, "closure")[0].sssp(SRC)
    for kw in (dict(queue_depth=1), dict(queue_depth=3, decode_workers=1),
               dict(prefetch=False)):
        eng = TS.StreamingQueryEngine(TS.IndexStore(path), device="cpu",
                                      **kw)
        try:
            _all_equal([want, eng.sssp(SRC)])
        finally:
            eng.close()


def test_store_backed_server_answers_as_in_memory(store_dir):
    path, _, ixt = store_dir
    rng = np.random.default_rng(5)
    requests = rng.integers(0, 150, 30).astype(np.int32)
    pairs = rng.integers(0, 150, (20, 2)).astype(np.int32)
    for mode, reqs in (("ssd", requests), ("sssp", requests),
                       ("p2p", pairs), ("within", requests),
                       ("knn", requests)):
        kw = dict(batch_size=8, mode=mode, within_d=7.0, knn_k=4)
        mem = tserve.QueryServer(T.QueryEngine(ixt, device="cpu"), **kw)
        st = tserve.QueryServer(store_path=path, warm_start=True,
                                cache_bytes=20000,
                                engine_opts={"device": "cpu"}, **kw)
        try:
            for a, b in zip(mem.serve_stream(reqs), st.serve_stream(reqs)):
                for f in ("dist", "pred", "nodes"):
                    if getattr(a, f) is not None:
                        np.testing.assert_array_equal(getattr(b, f),
                                                      getattr(a, f))
                assert (a.cached, a.source, a.target) \
                    == (b.cached, b.source, b.target)
            assert st.stats.page_misses > 0
            assert len(st.batch_io) == st.stats.batches
            assert sum(b.real_bytes for b in st.batch_io) \
                == st.stats.store_bytes_read
        finally:
            st.close()


def test_serve_cli_reports_the_servers_page_cache(tmp_path, monkeypatch,
                                                  capsys):
    """``--store`` on a small grid: the printed hit rate and bytes read
    are the served run's, and the temporary store is removed."""
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    stats = tserve.main(["--side", "10", "--requests", "24", "--batch",
                         "8", "--device", "cpu", "--store", "--cache-frac",
                         "0.05", "--codec", "delta", "--queue-depth", "2"])
    out = capsys.readouterr().out
    m = re.search(r"page cache: hit rate ([\d.]+)% \((\d+) hits / (\d+) "
                  r"misses\), (\d+) bytes read", out)
    assert m, out
    assert (int(m[2]), int(m[3]), int(m[4])) \
        == (stats.page_hits, stats.page_misses, stats.store_bytes_read)
    assert float(m[1]) == round(100 * stats.page_hit_rate(), 1)
    assert stats.requests == 24 and stats.store_bytes_read > 0
    assert "read pipeline (depth 2" in out
    assert not os.listdir(tmp_path)
