"""The port's async server and SLO scheduler (DESIGN.md §12).

First the cases of the JAX package's scheduler tests on the port's
``QueryServer`` (the fake ``_now`` clock, timer re-arming, per-mode and
per-parameter cache keys, deadline accounting, drain and close), then
the two packages side by side: one mixed request stream, submitted and
drained under ``fifo`` and under ``slo``, through the JAX server and the
port's on one index must give every request the same answer, batch and
cache hit, bit for bit.
"""
import asyncio
import io
import types

import numpy as np
import pytest

import repro.core as J
import repro.launch.serve as JS
import repro_torch.core as T
import repro_torch.launch.serve as serve_mod
from repro.config import Config as JConfig
from repro_torch.config import SERVE_DEFAULTS, Config, ConfigError
from repro_torch.launch.serve import (ClassSLO, QueryServer,
                                      mixed_request_stream,
                                      server_from_config)

_IX = {}


def indexes():
    """(JAX index, the port's index) of the JAX scheduler tests' graph."""
    if not _IX:
        g = J.gnm_random_digraph(150, 600, seed=4)
        res = J.build_hod(g, J.BuildConfig(max_core_nodes=32,
                                           max_core_edges=1024, seed=0))
        ixj = J.pack_index(g, res, chunk=64)
        buf = io.BytesIO()
        ixj.save(buf)
        buf.seek(0)
        with np.load(buf) as z:
            _IX["ix"] = (ixj, T.index_from_numpy(z))
    return _IX["ix"]


@pytest.fixture(scope="module")
def engine():
    return T.QueryEngine(indexes()[1], device="cpu")


def _fake_clock(server, t):
    """Freeze the scheduler's clock (the ``_now`` seam); returns the
    mutable clock object."""
    clock = types.SimpleNamespace(t=t)
    server._now = lambda: clock.t
    return clock


# ------------------------------------------------------- timer re-arming
def test_flush_due_rearms_for_straggler(engine):
    """A straggler left behind by a full-width take keeps its own
    submit-time budget, not now + max_wait."""
    server = QueryServer(engine, batch_size=2, max_wait_ms=50.0)
    clock = _fake_clock(server, 0.055)

    async def drive():
        loop = asyncio.get_running_loop()
        futs = [loop.create_future() for _ in range(3)]
        server._queues[serve_mod._FIFO] = [
            (41, futs[0], 0.000, "ssd"),     # due (flush-by 0.050)
            (42, futs[1], 0.001, "ssd"),
            (43, futs[2], 0.010, "ssd")]     # not due until 0.060
        server._flush_due()
        assert futs[0].done() and futs[1].done()
        assert not futs[2].done() and server.pending_count() == 1
        assert server._timer_deadline == pytest.approx(0.010 + 0.050)
        clock.t = 1.0                        # let the timer find it due
        r = await asyncio.wait_for(futs[2], timeout=10.0)
        assert r.source == 43
    asyncio.run(drive())
    assert server.pending_count() == 0


def test_straggler_keeps_budget_after_size_flush(engine):
    server = QueryServer(engine, batch_size=2, max_wait_ms=40.0)
    clock = _fake_clock(server, 5.0)

    async def drive():
        tasks = [asyncio.create_task(server.submit(s))
                 for s in (51, 52, 53)]
        for _ in range(4):
            await asyncio.sleep(0)
        assert server.stats.batches == 1 and server.pending_count() == 1
        assert server._timer_deadline == pytest.approx(5.0 + 0.040)
        clock.t = 6.0
        return await asyncio.gather(*tasks)

    results = asyncio.run(drive())
    assert [r.source for r in results] == [51, 52, 53]


def test_urgent_class_rearms_timer(engine):
    server = QueryServer(engine, batch_size=8, scheduler="slo",
                         modes=("ssd", "p2p"),
                         slo={"ssd": {"deadline_ms": 500.0},
                              "p2p": {"deadline_ms": 50.0}})
    _fake_clock(server, 2.0)

    async def drive():
        t1 = asyncio.create_task(server.submit(61))
        await asyncio.sleep(0)
        assert server._timer_deadline == pytest.approx(2.0 + 0.5)
        t2 = asyncio.create_task(server.submit(1, 2, mode="p2p"))
        await asyncio.sleep(0)
        assert server._timer_deadline == pytest.approx(2.0 + 0.05)
        await server.drain()
        return await asyncio.gather(t1, t2)

    r1, r2 = asyncio.run(drive())
    assert r1.mode == "ssd" and r2.mode == "p2p"


def test_flush_by_deadline_accounting(engine):
    server = QueryServer(engine, batch_size=4, max_wait_ms=7.0,
                         scheduler="slo", modes=("ssd", "p2p"),
                         slo={"ssd": {"deadline_ms": 100.0}})
    server._exec_ewma["ssd"] = 0.010
    entry = (0, None, 50.0, "ssd")
    assert server._flush_by(entry) == pytest.approx(
        50.0 + 0.100 - server.SLO_HEADROOM * 0.010)
    server._exec_ewma["ssd"] = 10.0          # hopeless deadline ->
    assert server._flush_by(entry) == 50.0   # clamped at submit time
    assert server._flush_by((0, None, 50.0, "p2p")) == pytest.approx(
        50.0 + 0.007)


# ----------------------------------------------------------- cache keys
def test_within_cache_keyed_by_threshold(engine):
    server = QueryServer(engine, batch_size=2, mode="within", within_d=8.0)
    r1 = server.serve_stream(np.array([5], np.int32))[0]
    server.within_d = 3.0                    # reconfigure the live server
    r2 = server.serve_stream(np.array([5], np.int32))[0]
    assert server.stats.cache_hits == 0 and server.stats.batches == 2
    np.testing.assert_array_equal(
        r2.dist, engine.ssd_within(np.array([5], np.int32), 3.0)[0])
    assert np.isfinite(r2.dist).sum() <= np.isfinite(r1.dist).sum()


def test_knn_cache_keyed_by_k(engine):
    server = QueryServer(engine, batch_size=2, mode="knn", knn_k=3)
    r1 = server.serve_stream(np.array([7], np.int32))[0]
    assert r1.nodes.shape == (3,)
    server.knn_k = 5
    r2 = server.serve_stream(np.array([7], np.int32))[0]
    assert r2.nodes.shape == (5,)
    assert server.stats.cache_hits == 0 and server.stats.batches == 2


def test_cache_not_shared_across_modes(engine):
    """A server with several modes never answers one mode's request with
    another mode's row: the cache key carries the mode."""
    server = QueryServer(engine, batch_size=2, modes=("ssd", "within"),
                         within_d=4.0)
    full = server.serve_stream(np.array([9], np.int32), mode="ssd")[0]
    clamp = server.serve_stream(np.array([9], np.int32), mode="within")[0]
    assert server.stats.cache_hits == 0 and server.stats.batches == 2
    assert np.isfinite(clamp.dist).sum() < np.isfinite(full.dist).sum()
    np.testing.assert_array_equal(
        clamp.dist, engine.ssd_within(np.array([9], np.int32), 4.0)[0])

    async def again():
        return (await server.submit(9, mode="within"),
                await server.submit(9, mode="ssd"))

    w, s = asyncio.run(again())
    assert w.cached and s.cached
    np.testing.assert_array_equal(w.dist, clamp.dist)
    np.testing.assert_array_equal(s.dist, full.dist)


# ----------------------------------------------- constructor validation
@pytest.mark.parametrize("kw", [
    dict(batch_size=0), dict(max_wait_ms=-1.0), dict(cache_entries=-1),
    dict(within_d=0.0), dict(knn_k=0), dict(queue_depth=0),
    dict(decode_workers=0), dict(pin_frac=1.5), dict(scheduler="lifo"),
    dict(mode="bogus"), dict(sssp=True, mode="p2p"),
    dict(mode="ssd", modes=("p2p",)), dict(modes=("ssd", "ssd")),
    dict(slo={"p2p": {"deadline_ms": 5.0}}),     # class not admitted
    dict(slo={"ssd": 5.0}),                      # spec not a mapping
    dict(slo={"ssd": {"deadline_ms": -1.0}}),
])
def test_ctor_validation(engine, kw):
    with pytest.raises(ValueError):
        QueryServer(engine, **kw)


def test_ctor_engine_xor_store(engine):
    with pytest.raises(ValueError):
        QueryServer()
    with pytest.raises(ValueError):
        QueryServer(engine, store_path="/tmp/nope")


def test_sharded_serving_is_refused(engine):
    cfg = Config(None, defaults=SERVE_DEFAULTS,
                 overrides={"serve": {"shards": 2}})
    with pytest.raises(NotImplementedError, match="fleet"):
        server_from_config(cfg, engine=engine)


def test_use_pallas_is_accepted_and_inert(engine):
    """``serve.use_pallas`` (carried by the checked-in configs) builds
    the same server: the engine keeps its device and kernels."""
    cfg = Config(None, defaults=SERVE_DEFAULTS,
                 overrides={"serve": {"use_pallas": True}})
    server = server_from_config(cfg, engine=engine)
    assert server.engine is engine and server.engine.device.type == "cpu"
    r = server.serve_stream(np.array([3], np.int32))[0]
    np.testing.assert_array_equal(r.dist,
                                  engine.ssd(np.array([3], np.int32))[0])


def test_class_slo_validation():
    with pytest.raises(ValueError):
        ClassSLO(deadline_ms=0.0)
    with pytest.raises(ValueError):
        ClassSLO(deadline_ms=5.0, batch=0)
    assert ClassSLO(deadline_ms=5.0).batch is None


def test_submit_validates_mode_and_target(engine):
    server = QueryServer(engine, batch_size=2)

    async def drive():
        with pytest.raises(ValueError):
            await server.submit(1, mode="p2p")   # not an admitted mode
        with pytest.raises(ValueError):
            await server.submit(1, 2)            # target outside p2p
    asyncio.run(drive())


# ----------------------------------------------------- drain() and close()
def test_drain_answers_everything_and_disarms_timer(engine):
    server = QueryServer(engine, batch_size=64, max_wait_ms=10_000.0)

    async def drive():
        tasks = [asyncio.create_task(server.submit(s))
                 for s in (71, 72, 73)]
        for _ in range(3):
            await asyncio.sleep(0)
        assert server.pending_count() == 3
        assert server._timer is not None         # in-flight flush timer
        await server.drain()
        assert server.pending_count() == 0
        assert server._timer is None and server._timer_deadline is None
        return await asyncio.gather(*tasks)

    results = asyncio.run(drive())
    direct = engine.ssd(np.array([71, 72, 73], np.int32))
    for r, d in zip(results, direct):
        np.testing.assert_array_equal(r.dist, d)


def test_close_fails_pending_futures(engine):
    server = QueryServer(engine, batch_size=64, max_wait_ms=10_000.0)

    async def drive():
        tasks = [asyncio.create_task(server.submit(s)) for s in (81, 82)]
        for _ in range(3):
            await asyncio.sleep(0)
        assert server.pending_count() == 2
        server.close()
        assert server.pending_count() == 0 and server._timer is None
        return await asyncio.gather(*tasks, return_exceptions=True)

    out = asyncio.run(drive())
    assert all(isinstance(e, RuntimeError) for e in out)  # nobody hangs
    assert "closed" in str(out[0])


# ------------------------------------------------- mixed-traffic scheduling
def test_fifo_take_splits_modes_in_arrival_order(engine):
    server = QueryServer(engine, batch_size=4, max_wait_ms=5_000.0,
                         modes=("ssd", "p2p"))

    async def drive():
        tasks = [asyncio.create_task(server.submit(1)),
                 asyncio.create_task(server.submit(2, 3, mode="p2p")),
                 asyncio.create_task(server.submit(2)),
                 asyncio.create_task(server.submit(4, 5, mode="p2p"))]
        return await asyncio.gather(*tasks)

    results = asyncio.run(drive())
    assert server.stats.batches == 2         # one take, two mode groups
    assert [r.mode for r in results] == ["ssd", "p2p", "ssd", "p2p"]
    assert all(r.batched_with == 2 for r in results)
    np.testing.assert_array_equal(
        results[0].dist, engine.ssd(np.array([1], np.int32))[0])
    np.testing.assert_array_equal(
        results[1].dist,
        np.float32(engine.p2p(np.array([2], np.int32),
                              np.array([3], np.int32))[0]))


def test_class_batch_cap_triggers_early_flush(engine):
    server = QueryServer(engine, batch_size=16, max_wait_ms=10_000.0,
                         scheduler="slo",
                         slo={"ssd": {"deadline_ms": 10_000.0,
                                      "batch": 2}})

    async def drive():
        tasks = [asyncio.create_task(server.submit(31)),
                 asyncio.create_task(server.submit(32))]
        for _ in range(3):
            await asyncio.sleep(0)
        assert server.pending_count() == 0   # cap hit: no timer wait
        return await asyncio.gather(*tasks)

    results = asyncio.run(drive())
    assert server.stats.batches == 1
    assert results[0].batched_with == 2
    assert server.stats.padded_slots == 14   # still padded to the shape


def test_deadline_miss_accounting(engine):
    server = QueryServer(engine, batch_size=4, max_wait_ms=1.0,
                         scheduler="slo",
                         slo={"ssd": {"deadline_ms": 0.0005}})

    async def drive():
        tasks = [asyncio.create_task(server.submit(s))
                 for s in (21, 22, 23)]
        await asyncio.sleep(0)
        await server.drain()
        return await asyncio.gather(*tasks)

    asyncio.run(drive())
    assert server.stats.deadline_misses == 3     # nothing beats 0.5us
    assert server.metrics.counter("slo.miss.ssd").value == 3
    rows = {r["cls"]: r for r in server.slo_report()}
    assert rows["ssd"]["deadline_misses"] == 3
    assert rows["ssd"]["requests"] == 3
    assert rows["ssd"]["deadline_ms"] == 0.0005


def test_warmup_runs_every_mode_twice_and_seeds_the_ewma(engine):
    calls = []
    server = QueryServer(engine, batch_size=4, modes=("ssd", "p2p"),
                         scheduler="slo",
                         slo={"p2p": {"deadline_ms": 60.0}})
    run = server._execute

    def spy(reqs, mode=None):
        calls.append(mode)
        return run(reqs, mode)

    server._execute = spy
    server.warmup()
    assert calls == ["ssd", "p2p", "ssd", "p2p"]
    assert set(server._exec_ewma) == {"ssd", "p2p"}
    assert server.stats.batches == 0 and not server._cache
    assert server.metrics.counter("server.batches").value == 0


@pytest.mark.parametrize("scheduler", ["fifo", "slo"])
def test_mixed_load_bit_identical_to_unscheduled(engine, scheduler):
    """Whatever the admission policy does to batching order, every
    answer is bit-identical to a singleton engine call."""
    cfg = Config(None, defaults=SERVE_DEFAULTS,
                 overrides={"serve": {"mix": {"ssd": 1, "p2p": 3}}})
    stream = mixed_request_stream(cfg, 150, 60,
                                  np.random.default_rng(11), p2p_pool=8)
    slo = ({"p2p": {"deadline_ms": 50.0, "batch": 4},
            "ssd": {"deadline_ms": 200.0}} if scheduler == "slo" else None)
    server = QueryServer(engine, batch_size=8, max_wait_ms=5.0,
                         modes=("ssd", "p2p"), scheduler=scheduler,
                         slo=slo)

    async def drive():
        tasks = [asyncio.create_task(server.submit(*args, mode=m))
                 for m, args in stream]
        await asyncio.sleep(0)
        await server.drain()
        return await asyncio.gather(*tasks)

    results = asyncio.run(drive())
    assert server.stats.requests == len(stream)
    for (m, args), r in zip(stream, results):
        if m == "p2p":
            s, t = args
            oracle = engine.p2p(np.array([s], np.int32),
                                np.array([t], np.int32))[0]
            np.testing.assert_array_equal(r.dist, np.float32(oracle))
        else:
            oracle = engine.ssd(np.array(args, np.int32))[0]
            np.testing.assert_array_equal(r.dist, oracle)
    rows = {r["cls"] for r in server.slo_report()}
    assert {"ssd", "p2p", "p2p.cached"} <= rows


# --------------------------------------------------------- config plumbing
def test_server_from_config_builds_mixed_server(engine):
    cfg = Config(None, defaults=SERVE_DEFAULTS, overrides={
        "serve": {"batch": 8, "scheduler": "slo",
                  "mix": {"ssd": 1, "p2p": 3},
                  "slo": {"p2p": {"deadline_ms": 40.0, "batch": 4}}}})
    server = server_from_config(cfg, engine=engine)
    assert server.modes == ("ssd", "p2p") and server.mode == "ssd"
    assert server.scheduler == "slo" and server.batch_size == 8
    assert server._slo["p2p"] == ClassSLO(deadline_ms=40.0, batch=4)


def test_server_from_config_threshold_alias(engine):
    cfg = Config(None, defaults=SERVE_DEFAULTS,
                 overrides={"serve": {"mode": "threshold",
                                      "threshold": 4.0}})
    server = server_from_config(cfg, engine=engine)
    assert server.mode == "within" and server.within_d == 4.0


def test_server_from_config_topk_builds_ssd_server(engine):
    cfg = Config(None, defaults=SERVE_DEFAULTS,
                 overrides={"serve": {"mode": "topk", "k": 3}})
    server = server_from_config(cfg, engine=engine)
    assert server.mode == "ssd" and server.modes == ("ssd",)


def test_server_from_config_rejects_unknown_slo_class(engine):
    cfg = Config(None, defaults=SERVE_DEFAULTS, overrides={
        "serve": {"scheduler": "slo", "mix": {"ssd": 1},
                  "slo": {"p2p": {"deadline_ms": 40.0}}}})
    with pytest.raises(ConfigError, match=r"serve\.slo\.p2p"):
        server_from_config(cfg, engine=engine)


# ------------------------------------------------ the two packages alike
#: Budgets far above any batch time: with the clock frozen, only the
#: size triggers and the drain flush, so both servers batch alike
#: whatever their engines' speeds.
MIX = {"serve": {"batch": 8, "max_wait_ms": 5000.0,
                 "mix": {"ssd": 1, "p2p": 3, "within": 1},
                 "threshold": 6.0, "cache_entries": 24,
                 "slo": {"p2p": {"deadline_ms": 5000.0, "batch": 4},
                         "ssd": {"deadline_ms": 20000.0}}}}


def _drive(server, stream, chunk):
    """Submit ``stream`` in chunks (each chunk's submits run before the
    next chunk starts) on a frozen clock, then drain; every request's
    result in order."""
    _fake_clock(server, 0.0)
    async def drive():
        tasks = []
        for lo in range(0, len(stream), chunk):
            tasks += [asyncio.create_task(server.submit(*args, mode=m))
                      for m, args in stream[lo:lo + chunk]]
            await asyncio.sleep(0)
        await server.drain()
        return await asyncio.gather(*tasks)
    return asyncio.run(drive())


@pytest.mark.parametrize("chunk", [7, 200])
@pytest.mark.parametrize("scheduler", ["fifo", "slo"])
def test_async_server_matches_jax(scheduler, chunk):
    """One mixed stream (ssd, p2p from a small pool, within) through the
    JAX server and the port's on one index: the same answer, batch
    partners and cache hit for every request, and the same counters."""
    ixj, ixt = indexes()
    over = {"serve": dict(MIX["serve"], scheduler=scheduler)}
    cj = JConfig(None, defaults=JS.SERVE_DEFAULTS, overrides=over)
    ct = Config(None, defaults=SERVE_DEFAULTS, overrides=over)
    sj = JS.server_from_config(cj, engine=J.QueryEngine(ixj))
    st = server_from_config(ct, engine=T.QueryEngine(ixt, device="cpu"))
    sj.warmup()
    st.warmup()
    stream = mixed_request_stream(ct, ixt.n, 90, np.random.default_rng(5),
                                  p2p_pool=6)
    assert stream == JS.mixed_request_stream(cj, ixj.n, 90,
                                             np.random.default_rng(5),
                                             p2p_pool=6)
    rj, rt = _drive(sj, stream, chunk), _drive(st, stream, chunk)
    assert len(rj) == len(rt) == len(stream)
    for a, b in zip(rj, rt):
        assert (a.mode, a.source, a.target, a.cached, a.batched_with) == \
            (b.mode, b.source, b.target, b.cached, b.batched_with)
        assert a.io_bytes == b.io_bytes
        for f in ("dist", "pred", "nodes"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                np.testing.assert_array_equal(y, x)
    for f in ("requests", "batches", "cache_hits", "padded_slots"):
        assert getattr(st.stats, f) == getattr(sj.stats, f), f
    assert st.stats.cache_hits > 0 and st.stats.padded_slots > 0
    counts = lambda s: {r["cls"]: r["requests"]  # noqa: E731
                        for r in s.slo_report()}
    assert counts(st) == counts(sj)
    assert {"ssd", "p2p", "p2p.cached", "within"} <= set(counts(st))
    for name in ("server.requests", "server.batches", "server.padded_slots",
                 "server.result_cache_hits", "server.batches.p2p",
                 "slo.requests.p2p"):
        assert st.metrics.counter(name).value == \
            sj.metrics.counter(name).value, name
