"""The port's serving fleet against the JAX package's (DESIGN.md §13).

A fleet partitions a store's blocks across N shards, each with its own
page-cache slice, modeled device and worker pools; the engine over it
is the unsharded one.  Here the port's ``StorePartition`` and
``split_budget`` equal the JAX package's on a grid of geometries, and
the port's ``ServingFleet`` (engine on the CPU) makes the JAX fleet's
page-cache transactions on one store at 1, 2 and 4 shards, raw and
delta, 5% and 25% budgets: the same answers, per-shard rows and cache
event sequence.  Then the JAX fleet tests' degenerate layouts and fault
path on the port, and ``configs/serve_fleet.yaml`` through both
packages' ``server_from_config`` on a frozen clock.  Fixtures are the
JAX fleet tests' (``gnm_random_digraph(150, 600)``, 1 KiB blocks).
"""
import asyncio
import dataclasses
import io
import os
import shutil
import types

import numpy as np
import pytest

import repro.core as J
import repro.fleet as JF
import repro.launch.serve as JV
import repro.storage as JS
import repro_torch.core as T
import repro_torch.fleet as TF
import repro_torch.launch.serve as TV
import repro_torch.storage as TS
from repro.config import Config as JConfig
from repro_torch.config import SERVE_DEFAULTS, Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLEET_CONFIG = os.path.join(REPO, "configs", "serve_fleet.yaml")
SRC = np.array([0, 3, 77, 149, 3], np.int32)


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
        return ixj, T.index_from_numpy(z)


@pytest.fixture(scope="module")
def stores(indexes, tmp_path_factory):
    """codec -> (the store the JAX package saved, the port's)."""
    ixj, ixt = indexes
    root = tmp_path_factory.mktemp("fleet_stores")
    out = {}
    for codec in ("raw", "delta"):
        j, t = str(root / f"jax_{codec}"), str(root / f"port_{codec}")
        ixj.save_store(j, block_bytes=1024, codec=codec)
        ixt.save_store(t, block_bytes=1024, codec=codec)
        out[codec] = (j, t)
    return out


def _budget(path, frac):
    return int(frac * TS.segment_logical_bytes(path))


# ------------------------------------------------ partition and budgets
SEG_GRID = [{"plan_f": 10, "plan_b": 7, "plan_core": 3},
            {"plan_f": 1, "plan_b": 2, "plan_core": 1},
            {"plan_f": 37, "plan_b": 4, "plan_core": 9},
            {"plan_f": 2}]


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("seg_blocks", SEG_GRID,
                         ids=lambda d: "-".join(map(str, d.values())))
def test_partition_equals_the_references(seg_blocks, n_shards):
    """owner, local_block, range_start, shard_blocks and describe, also
    with more shards than a segment has blocks and under an injected
    placement."""
    for owner_fn in (None, lambda name, block: block % n_shards):
        parts = [m.StorePartition(seg_blocks, n_shards, owner_fn=owner_fn)
                 for m in (JF, TF)]
        for name, n_blocks in seg_blocks.items():
            for b in range(1, n_blocks + 1):
                assert parts[1].owner(name, b) == parts[0].owner(name, b)
                assert parts[1].local_block(name, b) \
                    == parts[0].local_block(name, b)
            for s in range(n_shards + 1):
                assert parts[1].range_start(name, s) \
                    == parts[0].range_start(name, s)
        for s in range(n_shards):
            assert parts[1].shard_blocks(s) == parts[0].shard_blocks(s)
        assert parts[1].describe() == parts[0].describe()
    assert TF.REPLICATED_SEGMENTS == JF.REPLICATED_SEGMENTS


def test_partition_rejects_what_the_reference_rejects():
    for m in (JF, TF):
        part = m.StorePartition({"plan_f": 5}, 2)
        for bad in (0, 6):
            with pytest.raises(ValueError, match="out of range"):
                part.owner("plan_f", bad)
        with pytest.raises(ValueError, match="unknown segments"):
            m.StorePartition({"bogus": 5}, 2)
        with pytest.raises(ValueError, match="n_shards"):
            m.StorePartition({"plan_f": 5}, 0)


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 5])
def test_split_budget_equals_the_references(n_shards):
    """Budgets None and 1 byte to many blocks, 512 B and 4 KiB blocks,
    with and without owned footprints (empty shards included) and
    floors."""
    rng = np.random.default_rng(n_shards)
    owned_opts = [None, [0] * n_shards,
                  rng.integers(0, 40, n_shards).tolist(),
                  [50] + [0] * (n_shards - 1)]
    floor_opts = [None, [10_000] + [0] * (n_shards - 1),
                  rng.integers(0, 9000, n_shards).tolist()]
    n = 0
    for total in (None, 1, 1000, 10_000, 12_345, 1 << 20):
        for block in (512, 4096):
            for owned in owned_opts:
                for floors in floor_opts:
                    got = TF.split_budget(total, n_shards, block,
                                          owned_blocks=owned, floors=floors)
                    assert got == JF.split_budget(
                        total, n_shards, block, owned_blocks=owned,
                        floors=floors)
                    n += 1
    assert n == 6 * 2 * 4 * 3


# ------------------------------------------------- the fleets side by side
def _fleet_engine(pkg, path, n, budget, **kw):
    F, S = (JF, JS) if pkg == "jax" else (TF, TS)
    fleet = F.ServingFleet(path, n, cache_bytes=budget, **kw)
    opts = {} if pkg == "jax" else {"device": "cpu"}
    return S.StreamingQueryEngine(fleet.store, queue_depth=4, **opts), fleet


def _run_fleet(pkg, path, n, budget):
    """Two SSD passes around an SSSP query on an ``n``-shard fleet: the
    answers, the cache events in order, the per-shard rows and the
    aggregate CacheStats and IOStats."""
    eng, fleet = _fleet_engine(pkg, path, n, budget)
    log = []
    fleet.cache.on_event = lambda *e: log.append(e)
    try:
        out = [eng.ssd(SRC), *eng.sssp(SRC), eng.ssd(SRC[::-1])]
        st = fleet.stats()
        return (out, log, st.rows, dataclasses.asdict(st.cache),
                dataclasses.asdict(st.io), fleet.shard_budget_bytes)
    finally:
        eng.close()


@pytest.mark.parametrize("frac", [0.05, 0.25])
@pytest.mark.parametrize("codec", ["raw", "delta"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_fleet_equals_the_references(stores, codec, frac, n):
    """Both fleets serve one store (the JAX package's at 5%, the
    port's at 25%): bit-equal answers, the same cache event sequence,
    per-shard rows (hits, misses, bytes read and filled, budgets,
    blocks, modeled io seconds) and aggregate counters."""
    path = stores[codec][0 if frac < 0.25 else 1]
    budget = _budget(path, frac)
    want = _run_fleet("jax", path, n, budget)
    got = _run_fleet("port", path, n, budget)
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    assert got[1] == want[1] and got[1]
    assert got[2:] == want[2:]
    rows = got[2]
    assert len(rows) == n
    assert sum(r["bytes_read"] for r in rows) == got[3]["bytes_read"]
    if n == 2:
        assert all(r["hit_rate"] > 0 for r in rows if r["blocks"]) \
            or frac < 0.25


# ------------------------------------- the JAX fleet tests, on the port
def _solo_engine(path, budget):
    store = TS.IndexStore(path, cache=TS.PageCache(budget, policy="2q"))
    return TS.StreamingQueryEngine(store, queue_depth=4, device="cpu")


def test_n1_fleet_matches_plain_server(stores):
    """At N=1 the fleet keeps the exact budget, and its answers and
    aggregate CacheStats and IOStats equal an unsharded store's, counter
    for counter, over SSD and SSSP (pins) sweeps."""
    path = stores["delta"][1]
    budget = int(0.25 * TS.segment_bytes(path))
    srcs = np.arange(0, 150, 7, dtype=np.int32)
    solo = _solo_engine(path, budget)
    feng, fleet = _fleet_engine("port", path, 1, budget)
    try:
        np.testing.assert_array_equal(solo.ssd(srcs), feng.ssd(srcs))
        for a, b in zip(solo.sssp(srcs), feng.sssp(srcs)):
            np.testing.assert_array_equal(a, b)
        assert fleet.shard_budget_bytes == [budget]
        for which in ("cache", "device"):
            assert dataclasses.asdict(getattr(fleet.store, which).stats) \
                == dataclasses.asdict(getattr(solo.store, which).stats)
    finally:
        solo.close()
        feng.close()
    assert fleet._workers_down      # engine close shut the shard workers


def test_all_blocks_on_one_shard_still_bit_identical(stores):
    """owner_fn puts every partitioned block on shard 0: shard 1 sees
    no traffic, and no answer changes."""
    path = stores["delta"][1]
    budget = int(0.25 * TS.segment_bytes(path))
    srcs = np.arange(0, 150, 11, dtype=np.int32)
    solo = _solo_engine(path, budget)
    feng, fleet = _fleet_engine("port", path, 2, budget,
                                owner_fn=lambda name, block: 0)
    try:
        np.testing.assert_array_equal(solo.ssd(srcs), feng.ssd(srcs))
        idle = fleet.shards[1].cache.stats
        assert (idle.hits, idle.misses, idle.bytes_read) == (0, 0, 0)
        assert fleet.shards[0].cache.stats.misses > 0
    finally:
        solo.close()
        feng.close()


def test_sources_landing_on_empty_shard(indexes, tmp_path):
    """More shards than any segment has blocks: the tail shards own
    empty ranges, and every source still answers bit-identically."""
    ixt = indexes[1]
    path = str(tmp_path / "store")
    ixt.save_store(path, block_bytes=16384, codec="delta")
    probe = TS.IndexStore(path)
    n = max(probe.segment_blocks().values()) + 1
    probe.close()
    budget = int(0.25 * TS.segment_bytes(path))
    srcs = np.arange(0, 150, 5, dtype=np.int32)
    solo = _solo_engine(path, budget)
    feng, fleet = _fleet_engine("port", path, n, budget)
    try:
        assert any(fleet.partition.shard_blocks(s) == 0
                   for s in range(n)), "want at least one empty shard"
        np.testing.assert_array_equal(solo.ssd(srcs), feng.ssd(srcs))
        stats = fleet.stats()
        assert sum(r["bytes_read"] for r in stats.rows) == \
            stats.cache.bytes_read
        for r in stats.rows:
            if r["blocks"] == 0:
                assert r["hits"] + r["misses"] == 0
    finally:
        solo.close()
        feng.close()


def test_shard_worker_crc_error_raises_in_query_thread(stores, tmp_path):
    """A corrupt frame decoded on a shard's decode pool at N=2 surfaces
    in the querying thread, and again on the next query: the poisoned
    placeholder is discarded, not stuck."""
    path = str(tmp_path / "store")
    shutil.copytree(stores["delta"][1], path)
    with open(os.path.join(path, "plan_f.seg"), "r+b") as f:
        f.seek(2 * 1024 + 100)
        f.write(b"\xde\xad\xbe\xef" * 8)
    feng, _ = _fleet_engine("port", path, 2, None, decode_workers=2)
    try:
        for _ in range(2):
            with pytest.raises(ValueError, match="CRC mismatch"):
                feng.ssd(np.array([0], dtype=np.int32))
    finally:
        feng.close()


def test_fleet_rejects_bad_shards(stores):
    path = stores["raw"][1]
    with pytest.raises(ValueError, match="n_shards"):
        TF.ServingFleet(path, 0)
    for bad in (dict(shards=0), dict(shards=2, device=object())):
        with pytest.raises(ValueError, match="shards"):
            TV.QueryServer(store_path=path, engine_opts={"device": "cpu"},
                           **bad)


# --------------------------------------- the fleet config, both servers
def _frozen(server):
    """Freeze the scheduler's clock at 0 and drop the SLO headroom, so
    that no flush-by time is ever due: only the class batch sizes and
    the drain flush, and both servers batch alike whatever their
    engines' speeds."""
    clock = types.SimpleNamespace(t=0.0)
    server._now = lambda: clock.t
    server.SLO_HEADROOM = 0.0


def _drive(server, stream, chunk=11):
    _frozen(server)

    async def drive():
        tasks = []
        for lo in range(0, len(stream), chunk):
            tasks += [asyncio.create_task(server.submit(*args, mode=m))
                      for m, args in stream[lo:lo + chunk]]
            await asyncio.sleep(0)
        await server.drain()
        return await asyncio.gather(*tasks)
    return asyncio.run(drive())


def test_fleet_config_serves_as_the_references(indexes, stores):
    """``configs/serve_fleet.yaml`` (ssd:p2p 1:3, slo, delta, 2 shards)
    through each package's ``server_from_config`` on one delta store:
    every request the same answer, batch and cache hit, the same
    counters and per-shard rows."""
    path = stores["delta"][0]
    budget = _budget(path, 0.25)
    cj = JConfig(FLEET_CONFIG, defaults=JV.SERVE_DEFAULTS)
    ct = Config(FLEET_CONFIG, defaults=SERVE_DEFAULTS)
    assert ct.data == cj.data and ct.get("serve.shards") == 2
    n_req = int(ct.get("serve.requests"))
    stream = TV.mixed_request_stream(ct, 150, n_req,
                                     np.random.default_rng(5))
    assert stream == JV.mixed_request_stream(cj, 150, n_req,
                                             np.random.default_rng(5))
    sj = JV.server_from_config(cj, store_path=path, cache_bytes=budget)
    st = TV.server_from_config(ct, store_path=path, cache_bytes=budget,
                               engine_opts={"device": "cpu"})
    try:
        assert st.fleet is not None and st.fleet.n_shards == 2
        sj.warmup()
        st.warmup()
        rj, rt = _drive(sj, stream), _drive(st, stream)
        assert len(rt) == len(stream)
        for a, b in zip(rj, rt):
            assert (a.mode, a.source, a.target, a.cached,
                    a.batched_with) == (b.mode, b.source, b.target,
                                        b.cached, b.batched_with)
            np.testing.assert_array_equal(b.dist, a.dist)
        for f in ("requests", "batches", "cache_hits", "padded_slots",
                  "page_hits", "page_misses", "store_bytes_read",
                  "store_bytes_filled"):
            assert getattr(st.stats, f) == getattr(sj.stats, f), f
        fj, ft = sj.fleet_report(), st.fleet_report()
        assert ft.rows == fj.rows
        assert ft.report_lines() == fj.report_lines()
        assert ft.cache.bytes_read == st.stats.store_bytes_read > 0
    finally:
        sj.close()
        st.close()
    assert st.fleet._workers_down


def test_cli_serves_the_fleet_config(capsys):
    """The serve CLI takes ``configs/serve_fleet.yaml`` (shards imply
    the store) and prints one fleet line per shard."""
    stats = TV.main(["--device", "cpu", "--side", "12", "--config",
                     FLEET_CONFIG])
    out = capsys.readouterr().out
    assert stats.requests == 96
    assert "fleet: 2 shards" in out
    assert "  shard 0:" in out and "  shard 1:" in out
    assert "store: delta codec" in out


@pytest.mark.parametrize("module", ["storage", "fleet"])
def test_smoke_runs_on_the_cpu(module, capsys):
    """``python -m repro_torch.{storage,fleet}.smoke --device cpu``."""
    import importlib
    importlib.import_module(f"repro_torch.{module}.smoke").main(
        ["--device", "cpu"])
    assert f"{module} smoke OK on cpu" in capsys.readouterr().out


def test_shard_pools_under_a_short_switch_interval(stores):
    """4 shards with 4 decoders each (more threads than this test's
    cores) and a 1 us switch interval: 12 sweeps in a row answer as the
    unsharded engine, and the per-shard rows equal those of the same
    fleet run at the default interval, so no fill is lost or raced
    between the shards' workers and the query thread."""
    import sys
    import threading
    path = stores["delta"][1]
    budget = _budget(path, 0.05)
    rng = np.random.default_rng(11)
    batches = [rng.integers(0, 150, 6).astype(np.int32) for _ in range(12)]
    solo = _solo_engine(path, budget)
    want = [solo.ssd(src) for src in batches]
    solo.close()
    rows = []
    for interval in (1e-6, None):
        old = sys.getswitchinterval()
        if interval is not None:
            sys.setswitchinterval(interval)
        feng, fleet = _fleet_engine("port", path, 4, budget,
                                    decode_workers=4)
        try:
            for src, w in zip(batches, want):
                np.testing.assert_array_equal(feng.ssd(src), w)
            rows.append(fleet.stats().rows)
        finally:
            sys.setswitchinterval(old)
            feng.close()
    assert rows[0] == rows[1]
    assert not [t for t in threading.enumerate()
                if t.name.startswith("hod-shard") and t.is_alive()]
