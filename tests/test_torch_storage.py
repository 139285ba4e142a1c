"""The port's block store against the JAX package's: files, cache, I/O.

Both packages read and write the same store directory: the port's
``save_store`` writes segment files byte-equal to the JAX package's for
each codec, and each package loads the other's store with bit-exact
plans.  The port's ``StreamingQueryEngine`` (on the CPU) makes the same
page-cache transactions as the JAX package's on the same queries: the
sequence of ``PageCache.on_event`` events (kind, key, bytes) and the
device's ``IOStats`` are equal at budgets of 5% and 25% over the raw,
delta and f16 codecs, at queue depths 1 and 4 and without the
pipeline.  Fixtures are the JAX storage tests' (``gnm_random_digraph
(150, 600)``, ``block_bytes=1024``).
"""
import dataclasses
import filecmp
import io
import os
import shutil

import numpy as np
import pytest

import repro.core as J
import repro.storage as JS
import repro_torch.core as T
import repro_torch.storage as TS

CODECS = ("raw", "delta", "f16")
PLANS = ("plan_f", "plan_b", "plan_core")
SEGMENTS = tuple(f"{p}.seg" for p in PLANS)
SRC = np.array([0, 3, 77, 149, 3], np.int32)
TGT = np.array([5, 140, 0, 60, 99], np.int32)


@pytest.fixture(scope="module")
def indexes():
    """(JAX index, the port's index read from its .npz roster)."""
    g = J.gnm_random_digraph(150, 600, seed=4, weighted=True)
    res = J.build_hod(g, J.BuildConfig(max_core_nodes=32,
                                       max_core_edges=1024, seed=0))
    ixj = J.pack_index(g, res, chunk=64)
    buf = io.BytesIO()
    ixj.save(buf)
    buf.seek(0)
    with np.load(buf) as z:
        ixt = T.index_from_numpy(z)
    return ixj, ixt


@pytest.fixture(scope="module")
def stores(indexes, tmp_path_factory):
    """codec -> (the JAX package's store, the port's store)."""
    ixj, ixt = indexes
    root = tmp_path_factory.mktemp("stores")
    out = {}
    for codec in CODECS:
        j, t = str(root / f"jax_{codec}"), str(root / f"port_{codec}")
        ixj.save_store(j, block_bytes=1024, codec=codec)
        ixt.save_store(t, block_bytes=1024, codec=codec)
        out[codec] = (j, t)
    return out


def _plans_equal(a, b):
    for name in PLANS:
        pa, pb = getattr(a, name), getattr(b, name)
        for f in ("dst", "src_idx", "w", "assoc", "row_valid",
                  "level_mask"):
            np.testing.assert_array_equal(getattr(pa, f), getattr(pb, f))


# ------------------------------------------------------------- the files
@pytest.mark.parametrize("codec", CODECS)
def test_segment_files_byte_equal(stores, codec):
    j, t = stores[codec]
    for seg in SEGMENTS:
        assert filecmp.cmp(os.path.join(j, seg), os.path.join(t, seg),
                           shallow=False), seg
    assert TS.segment_bytes(t) == JS.segment_bytes(j)
    assert TS.segment_logical_bytes(t) == JS.segment_logical_bytes(j)


@pytest.mark.parametrize("codec", CODECS)
def test_each_package_loads_the_others_store(indexes, stores, codec):
    ixj, ixt = indexes
    j, t = stores[codec]
    from_jax = T.HoDIndex.load_store(j)
    from_port = J.HoDIndex.load_store(t)
    _plans_equal(from_jax, ixj)
    _plans_equal(from_port, ixt)
    _plans_equal(T.HoDIndex.load(t), ixj)       # load() takes a directory
    for k in T.HoDIndex._ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(from_jax, k), getattr(ixj, k))
        np.testing.assert_array_equal(getattr(from_port, k), getattr(ixt, k))


@pytest.mark.parametrize("version", [3, 4])
def test_older_segment_layouts_load(indexes, tmp_path, version):
    """Stores with v3 (block-aligned full slabs) and v4 (affinity slabs,
    footer CRCs) segments, forged as the JAX package's tests forge them,
    load with bit-exact plans and stream the same answers."""
    from test_storage import _forge_v3_segment, _forge_v4_segment
    forge = {3: _forge_v3_segment, 4: _forge_v4_segment}[version]
    ixj, ixt = indexes
    path = str(tmp_path / "store")
    ixt.save_store(path, block_bytes=1024)
    for name in PLANS:
        forge(os.path.join(path, f"{name}.seg"), getattr(ixj, name),
              ixj.n, 1024)
    _plans_equal(T.HoDIndex.load(path), ixj)
    want = T.QueryEngine(ixt, device="cpu").sssp(SRC)
    for prefetch in (False, True):
        eng = TS.StreamingQueryEngine(TS.IndexStore(path), device="cpu",
                                      prefetch=prefetch)
        try:
            for a, b in zip(eng.sssp(SRC), want):
                np.testing.assert_array_equal(a, b)
            assert {s.version for s in eng.store.segments.values()} \
                == {version}
        finally:
            eng.close()


def test_store_resident_tier_is_plan_less(stores):
    store = TS.IndexStore(stores["raw"][0])
    try:
        ix = store.resident
        assert ix.plan_f is None and ix.plan_b is None
        assert set(ix.resident_arrays()) == set(T.HoDIndex._ARRAY_FIELDS)
        jstore = JS.IndexStore(stores["raw"][0])
        try:
            for sssp in (False, True):
                for mode in ("closure", "bellman"):
                    assert store.scan_bytes(sssp, mode) \
                        == jstore.scan_bytes(sssp, mode)
        finally:
            jstore.close()
    finally:
        store.close()


def test_store_rejects_a_device_of_another_block_size(stores):
    from repro_torch.core.io_sim import BlockDevice
    with pytest.raises(ValueError, match="block size"):
        TS.IndexStore(stores["raw"][1], device=BlockDevice(block_bytes=512))


# --------------------------------------------------------- the page cache
@pytest.mark.parametrize("policy", ["lru", "clock", "2q", "arc"])
def test_page_cache_replays_the_references_events(policy):
    """The copied cache makes the reference's transactions on one
    random trace of gets, pins and unpins, event for event."""
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 40, 600)
    sizes = rng.integers(50, 200, 40)
    caches = [m.PageCache(2000, policy=policy, pin_frac=0.3)
              for m in (JS, TS)]
    logs = [[], []]
    for cache, log in zip(caches, logs):
        cache.on_event = lambda *e, log=log: log.append(e)
        for i, k in enumerate(keys.tolist()):
            cache.get(k, lambda k=k: b"x" * int(sizes[k]), pin=i % 7 == 0)
            if i % 11 == 0:
                cache.unpin([k])
    assert logs[0] == logs[1] and logs[0]
    assert dataclasses.asdict(caches[0].stats) \
        == dataclasses.asdict(caches[1].stats)
    assert caches[0].resident_keys() == caches[1].resident_keys()


# ------------------------------------------- the engines' cache and I/O
def _budget(path, frac):
    return int(frac * TS.segment_logical_bytes(path))


def _engine(pkg, path, frac, queue_depth=4, prefetch=True, **kw):
    store = pkg.IndexStore(path, cache=pkg.PageCache(_budget(path, frac),
                                                     policy="2q"))
    if pkg is TS:
        kw.setdefault("device", "cpu")
    return pkg.StreamingQueryEngine(store, prefetch=prefetch,
                                    queue_depth=queue_depth, **kw)


def _run_logged(eng, methods):
    """Run ``methods`` on ``eng``; return the cache's events, its
    counters and the device's IOStats."""
    log = []
    eng.store.cache.on_event = lambda *e: log.append(e)
    try:
        for m in methods:
            m(eng)
        st = eng.store.cache.stats
        return (log, (st.hits, st.misses, st.evictions, st.bytes_read,
                      st.bytes_filled),
                dataclasses.asdict(eng.store.device.stats))
    finally:
        eng.close()


SWEEPS = (lambda e: e.ssd(SRC), lambda e: e.sssp(SRC), lambda e: e.ssd(SRC))


@pytest.mark.parametrize("pipe", ["depth1", "depth4", "sync"])
@pytest.mark.parametrize("frac", [0.05, 0.25])
@pytest.mark.parametrize("codec", CODECS)
def test_cache_events_and_io_equal_the_references(stores, codec, frac,
                                                  pipe):
    """Two SSD passes around an SSSP query (pins, recon re-reads, warm
    hits): the same events in the same order, the same counters, the
    same device IOStats as the JAX engine at the same setting."""
    path = stores[codec][0]
    kw = {"depth1": dict(queue_depth=1), "depth4": dict(queue_depth=4),
          "sync": dict(prefetch=False)}[pipe]
    want = _run_logged(_engine(JS, path, frac, **kw), SWEEPS)
    got = _run_logged(_engine(TS, path, frac, **kw), SWEEPS)
    assert got[0] == want[0]
    assert got[1:] == want[1:]
    hits, misses = got[1][:2]
    assert misses > 0 and (frac < 0.25 or hits > 0)


def test_bounded_sweeps_read_what_the_reference_reads(stores):
    """P2P (early stop on and off), threshold, kNN and the top-k prune
    read synchronously and skip the same levels as the reference."""
    path = stores["delta"][0]
    methods = (lambda e: e.p2p(SRC, TGT),
               lambda e: e.p2p(SRC, TGT, early_term=False),
               lambda e: e.ssd_within(SRC, 6.0),
               lambda e: e.knn(SRC, 5),
               lambda e: e.ssd_bounded(SRC, 40.0),
               lambda e: e.ssd_bounded(SRC, float("inf")))
    want = _run_logged(_engine(JS, path, 0.05), methods)
    got = _run_logged(_engine(TS, path, 0.05), methods)
    assert got == want


def test_server_counters_equal_the_references(stores):
    """A store-backed server's page-cache counters and real bytes per
    batch equal the JAX server's on one request stream."""
    from repro.launch.serve import QueryServer as JQ

    from repro_torch.launch.serve import QueryServer as TQ
    path = stores["raw"][0]
    rng = np.random.default_rng(3)
    requests = rng.choice(rng.choice(150, 12, replace=False),
                          40).astype(np.int32)
    budget = _budget(path, 0.25)
    js = JQ(store_path=path, cache_bytes=budget, batch_size=8,
            cache_entries=8)
    ts = TQ(store_path=path, cache_bytes=budget, batch_size=8,
            cache_entries=8, engine_opts={"device": "cpu"})
    try:
        rj, rt = js.serve_stream(requests), ts.serve_stream(requests)
        for a, b in zip(rj, rt):
            np.testing.assert_array_equal(b.dist, a.dist)
            assert (b.cached, b.source) == (a.cached, a.source)
        for f in ("requests", "batches", "cache_hits", "padded_slots",
                  "page_hits", "page_misses", "store_bytes_read",
                  "store_bytes_filled"):
            assert getattr(ts.stats, f) == getattr(js.stats, f), f
        assert [dataclasses.astuple(b)[:-1] for b in ts.batch_io] \
            == [dataclasses.astuple(b)[:-1] for b in js.batch_io]
        assert ts.modeled_scan_bytes == js.modeled_scan_bytes
        io_t = ts.modeled_io()
        assert io_t.bytes_seq + io_t.bytes_rand == ts.stats.store_bytes_read
    finally:
        js.close()
        ts.close()


# ------------------------------------------------ the device and faults
def _level_bytes(ix):
    """The most bytes one level of any plan takes as a [M_pad, K_fix]
    slab (dst, src_idx, w, assoc, valid), 16-byte slack an array."""
    most = 0
    for name in PLANS:
        p = getattr(ix, name)
        most = max(most, p.m_pad * (4 + 1 + 12 * p.k_fix))
    return most + 6 * 16


def test_one_level_on_the_device_at_a_time(indexes, stores):
    """Every level moves to the device in its own copy, and no copy is
    larger than one level: an SSD moves each distance level once, an
    SSSP each distance and reconstruction level once."""
    ixj, ixt = indexes
    eng = _engine(TS, stores["raw"][0], 0.25)
    try:
        st = eng._stager
        n_f, n_b = (eng.store.n_real(p) for p in ("plan_f", "plan_b"))
        eng.ssd(SRC)
        assert st.copies == n_f + n_b
        eng.sssp(SRC)
        assert st.copies == 2 * (n_f + n_b) + n_f + n_b \
            + eng.store.n_real("plan_core")
        assert 0 < st.peak_bytes <= _level_bytes(ixt)
        whole = min(getattr(ixt, p).nbytes() for p in ("plan_f", "plan_b"))
        assert st.peak_bytes < whole
        assert eng.times.levels == 2 * (n_f + n_b)
    finally:
        eng.close()


@pytest.mark.parametrize("prefetch", [False, True])
def test_corrupt_segment_raises_in_the_querying_thread(stores, tmp_path,
                                                       prefetch):
    path = str(tmp_path / "store")
    shutil.copytree(stores["raw"][1], path)
    with open(os.path.join(path, "plan_f.seg"), "r+b") as f:
        f.seek(2 * 1024 + 100)
        f.write(b"\xde\xad\xbe\xef" * 8)
    eng = TS.StreamingQueryEngine(TS.IndexStore(path), prefetch=prefetch,
                                  device="cpu")
    try:
        with pytest.raises(ValueError, match="CRC mismatch"):
            eng.ssd(SRC)
    finally:
        eng.close()


def _core_keys(store):
    keys = set()
    for lvl in range(store.n_real("plan_core")):
        keys |= set(store.segments["plan_core"].level_keys(lvl))
    return keys


@pytest.mark.parametrize("fail", [False, True])
def test_recon_pins_are_released(stores, fail):
    """After an SSSP query only the sticky plan_core pins remain — also
    when a reconstruction level raises midway."""
    eng = _engine(TS, stores["raw"][1], 0.25)
    try:
        if fail:
            calls = []

            def boom(*args):
                calls.append(1)
                if len(calls) == 3:
                    raise RuntimeError("level body failed")
                return type(eng)._recon_level(eng, *args)

            eng._recon_level = boom
            with pytest.raises(RuntimeError, match="level body failed"):
                eng.sssp(SRC)
        else:
            eng.sssp(SRC)
        leftover = set(eng.store.cache.pinned_keys()) - _core_keys(eng.store)
        assert not leftover, f"leaked pin leases: {leftover}"
        eng._recon_level = type(eng)._recon_level.__get__(eng)
        d, _ = eng.sssp(SRC)                    # the engine still serves
        np.testing.assert_array_equal(d, eng.ssd(SRC))
    finally:
        eng.close()


def test_abandoned_sweep_drains_its_pipeline(stores):
    """A consumer that stops mid-sweep leaves no fill in flight: the
    generator's cleanup waits out the tickets, and later sweeps answer
    as before."""
    eng = _engine(TS, stores["delta"][1], 0.05, queue_depth=4)
    try:
        want = eng.ssd(SRC)
        ps = eng.pipeline_stats()
        ps.reset()
        gen = eng._levels("plan_f")
        next(gen)
        gen.close()
        # the window of 4, topped up once before the first reap
        n_f = eng.store.n_real("plan_f")
        assert (ps.submitted, ps.levels) == (min(5, n_f), 1)
        np.testing.assert_array_equal(eng.ssd(SRC), want)
    finally:
        eng.close()


def test_pipeline_and_server_reject_bad_sizes(stores):
    from repro_torch.launch.serve import QueryServer
    path = stores["raw"][1]
    with pytest.raises(ValueError, match="queue_depth"):
        _engine(TS, path, 0.25, queue_depth=0)
    with pytest.raises(ValueError, match="either an engine or a store"):
        QueryServer(T.QueryEngine(T.HoDIndex.load_store(path),
                                  device="cpu"), store_path=path)
    with pytest.raises(ValueError, match="an engine or a store_path"):
        QueryServer()
    for bad in (dict(queue_depth=0), dict(decode_workers=0),
                dict(pin_frac=1.5)):
        with pytest.raises(ValueError):
            QueryServer(store_path=path, engine_opts={"device": "cpu"},
                        **bad)
