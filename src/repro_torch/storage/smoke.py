"""Storage smoke check: build → ``save_store`` → serve from the store
at 5% and 25% page-cache budgets → verify against the in-memory oracle
— then repeat the 25% run from a ``delta``-codec store.  The port's twin
of the JAX package's ``storage/smoke.py``: the engines run on the card
(``edge_relax`` a streamed level, ``tropical_matmul`` for the core)
unless it is given ``--device cpu``.

Asserts end to end:

* store-served distances are **bit-identical** to the in-memory
  engine's and match the Dijkstra oracle to float tolerance;
* the page cache is genuinely memory-constrained (hit-rate < 1.0 at a
  5% budget);
* the server's ``IOStats`` come from *actual* block reads — every byte
  the device metered is a byte the cache read on a miss, and no
  synthetic scan charge was applied;
* a partial budget actually buys hit-rate: at 25% under the default
  scan-resistant policy the hit rate must be strictly positive (an LRU
  cache thrashes to 0.0 here);
* the ``delta`` codec (format v5) pays off at the same 25% budget:
  smaller segments on disk, fewer compressed bytes read, hit rate no
  worse than the raw store (the logical block space and the
  decompressed-byte budget are identical, so the access/hit sequence
  is too), and answers still bit-identical;
* store-backed P2P (DESIGN.md §7): served pair answers equal
  the full SSD rows' entries, and a cold P2P sweep reads strictly
  fewer bytes than a cold full sweep from the same source;
* the depth-4 read pipeline: a ``queue_depth=4`` server
  answers bit-identically to ``queue_depth=1`` while reading exactly
  the same bytes and hit/miss sequence (cache transactions are
  submit-ordered) and exposes the overlap metrics (time-to-first-level
  ticks, stall counters present);
* kNN mode: store-served ``--mode knn`` answers
  equal the in-memory engine's k-nearest rows exactly;
* end-to-end tracing (DESIGN.md §11): a *mixed* ssd + p2p
  workload served under a ``Tracer`` yields answers and cache counter
  sequences bit-identical to the untraced twin, the exported Chrome
  trace validates (balanced B/E, monotonic ts per tid) and contains
  the span taxonomy, read/decode/relax overlap is visible at queue
  depth 4, and the metrics snapshot carries sane per-mode latency
  histograms.  Set ``SMOKE_TRACE_OUT=<path>`` to keep the Chrome
  trace;
* the declarative config spine (DESIGN.md §12): the
  checked-in ``configs/serve_mixed.yaml`` (or an inline twin when the
  file is absent) builds a store-backed mixed ssd+p2p server under
  the ``slo`` scheduler with two SLO classes via
  ``server_from_config``; every answer is bit-identical to singleton
  in-memory engine calls and ``slo_report`` carries both classes'
  deadline accounting.

    PYTHONPATH=src python -m repro_torch.storage.smoke
    PYTHONPATH=src python -m repro_torch.storage.smoke --device cpu
"""
from __future__ import annotations

import argparse
import asyncio
import os
import tempfile
from typing import List, Optional

import numpy as np

from ..core import (BuildConfig, QueryEngine, build_hod, dijkstra_reference,
                    gnm_random_digraph, pack_index)
from ..device import resolve_device
from ..launch.serve import QueryServer
from .blockfile import segment_bytes

N_QUERIES = 16


def _serve_and_verify(store_dir: str, budget: int, sources: np.ndarray,
                      direct: np.ndarray, device: str,
                      **server_kw) -> QueryServer:
    """Serve from the store at one cache budget (bytes) and assert the
    answers are bit-identical to the in-memory engine's rows."""
    server = QueryServer(store_path=store_dir, cache_bytes=budget,
                         batch_size=8, cache_entries=0, warm_start=True,
                         engine_opts={"device": device}, **server_kw)
    try:
        results = server.serve_stream(sources)
    finally:
        server.close()
    for i, r in enumerate(results):
        np.testing.assert_array_equal(r.dist, direct[i])
    return server


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    dev = str(resolve_device(ap.parse_args(argv).device))
    g = gnm_random_digraph(200, 800, seed=11, weighted=True)
    res = build_hod(g, BuildConfig(max_core_nodes=32, max_core_edges=1024,
                                   seed=0))
    ix = pack_index(g, res, chunk=64, device=dev)
    rng = np.random.default_rng(0)
    sources = rng.choice(g.n, size=N_QUERIES,
                         replace=False).astype(np.int32)
    eng_mem = QueryEngine(ix, device=dev)
    direct = eng_mem.ssd(sources)
    oracle = dijkstra_reference(g, sources[:4])
    for i in range(4):
        finite = np.isfinite(oracle[i])
        assert np.allclose(direct[i][: g.n][finite], oracle[i][finite],
                           rtol=1e-5)

    with tempfile.TemporaryDirectory() as tmp:
        store_dir = f"{tmp}/store"
        ix.save_store(store_dir, block_bytes=4096)
        raw_seg = segment_bytes(store_dir)

        server = _serve_and_verify(store_dir, int(0.05 * raw_seg),
                                   sources, direct, dev)
        st = server.stats
        io = server.modeled_io()
        assert st.page_misses > 0, "no real block reads happened"
        assert st.page_hit_rate() < 1.0, \
            f"hit-rate {st.page_hit_rate()} not memory-constrained at 5%"
        assert io.bytes_seq + io.bytes_rand == st.store_bytes_read, \
            "device bytes != actual cache-miss reads (synthetic charge?)"

        # 25% budget: the scan-resistant default (2Q + affinity layout)
        # must buy actual hit-rate — 0.0 here means cyclic-scan thrash
        # is back (the PR-3 LRU baseline).
        budget25 = int(0.25 * raw_seg)
        st25 = _serve_and_verify(store_dir, budget25, sources, direct,
                                 dev).stats
        assert st25.page_hit_rate() > 0.0, \
            "25% cache budget bought a 0.0 hit rate — scan-resistant " \
            "policy or affinity layout regressed"

        # delta-codec store (format v5) at the SAME decompressed-byte
        # budget: smaller on disk, fewer compressed bytes read, hit
        # rate no worse than raw, answers still bit-identical.
        delta_dir = f"{tmp}/store_delta"
        ix.save_store(delta_dir, block_bytes=4096, codec="delta")
        delta_seg = segment_bytes(delta_dir)
        assert delta_seg < raw_seg, \
            f"delta segments ({delta_seg}) not smaller than raw ({raw_seg})"
        std = _serve_and_verify(delta_dir, budget25, sources, direct,
                                dev).stats
        assert std.page_hit_rate() >= st25.page_hit_rate(), \
            f"delta hit rate {std.page_hit_rate():.3f} < raw " \
            f"{st25.page_hit_rate():.3f} at the same budget"
        assert std.store_bytes_read < st25.store_bytes_read, \
            "delta store read no fewer bytes than raw"
        assert std.store_bytes_filled > std.store_bytes_read, \
            "decompress-on-fill accounting missing (filled <= read)"

        # Depth-4 read pipeline: identical answers, identical
        # bytes and hit/miss sequence vs depth 1, overlap metrics live.
        st_d1 = _serve_and_verify(delta_dir, budget25, sources, direct,
                                  dev, queue_depth=1).stats
        st_d4 = _serve_and_verify(delta_dir, budget25, sources, direct,
                                  dev, queue_depth=4,
                                  decode_workers=2).stats
        assert st_d4.store_bytes_read == st_d1.store_bytes_read, \
            f"depth-4 read {st_d4.store_bytes_read} bytes, depth-1 " \
            f"{st_d1.store_bytes_read} — read-ahead changed the " \
            "cache sequence"
        assert (st_d4.page_hits, st_d4.page_misses) == \
            (st_d1.page_hits, st_d1.page_misses), \
            "depth-4 hit/miss sequence diverged from depth-1"
        assert st_d4.ttfl_seconds > 0.0, \
            "pipelined server never recorded a time-to-first-level"
        assert st_d4.stall_seconds >= 0.0 \
            and st_d4.stall_wall_seconds >= 0.0

        # kNN: store-served k-nearest rows
        # must equal the in-memory engine's exactly (shared selection
        # + tie-breaking).
        knodes, kdist = eng_mem.knn(sources, 5)
        knn_server = QueryServer(store_path=store_dir,
                                 cache_bytes=budget25, batch_size=8,
                                 cache_entries=0, mode="knn", knn_k=5,
                                 engine_opts={"device": dev},
                                 warm_start=True)
        try:
            knn_results = knn_server.serve_stream(sources)
        finally:
            knn_server.close()
        for i, r in enumerate(knn_results):
            np.testing.assert_array_equal(r.nodes, knodes[i])
            np.testing.assert_array_equal(r.dist, kdist[i])

        # P2P: serve pairs store-backed; answers must
        # equal the full SSD rows' entries, the cache must still see
        # real traffic, and a cold meet-in-the-middle sweep must read
        # strictly fewer bytes than a cold full sweep.
        targets = rng.choice(g.n, size=N_QUERIES,
                             replace=False).astype(np.int32)
        pairs = np.stack([sources, targets], axis=1)
        p2p_server = QueryServer(store_path=store_dir,
                                 cache_bytes=budget25, batch_size=8,
                                 cache_entries=0, mode="p2p",
                                 engine_opts={"device": dev},
                                 warm_start=True)
        try:
            p2p_results = p2p_server.serve_stream(pairs)
        finally:
            p2p_server.close()
        for i, r in enumerate(p2p_results):
            np.testing.assert_array_equal(
                r.dist, np.float32(direct[i][targets[i]]))
        stp = p2p_server.stats
        assert stp.page_hits + stp.page_misses > 0, \
            "p2p served without touching the page cache"
        assert 0.0 < stp.page_hit_rate() <= 1.0

        from . import IndexStore, PageCache, StreamingQueryEngine
        cold = StreamingQueryEngine(IndexStore(store_dir,
                                               cache=PageCache(0)),
                                    prefetch=False, device=dev)
        try:
            dstats = cold.store.device.stats
            # endpoints at level > 0, so both halves provably skip levels
            from ..core.index import node_levels
            lvl = node_levels(ix, np.arange(ix.n))[ix.perm]
            mid = np.nonzero((lvl > 0) & (lvl < ix.n_levels))[0]
            one_s = mid[:1].astype(np.int32)
            one_t = mid[-1:].astype(np.int32)
            base = dstats.bytes_seq + dstats.bytes_rand
            cold.ssd(one_s)
            ssd_bytes = dstats.bytes_seq + dstats.bytes_rand - base
            base = dstats.bytes_seq + dstats.bytes_rand
            cold.p2p(one_s, one_t)
            p2p_bytes = dstats.bytes_seq + dstats.bytes_rand - base
        finally:
            cold.close()
        assert 0 < p2p_bytes < ssd_bytes, \
            f"p2p read {p2p_bytes} bytes, full sweep {ssd_bytes} — " \
            "meet-in-the-middle is not saving I/O"

        # Traced mixed serve (DESIGN.md §11): alternate ssd and
        # p2p batches through one shared depth-4 engine under a Tracer.
        # Tracing must be a pure observer — answers and cache counter
        # totals bit-identical to the untraced twin — and the Chrome
        # export must validate, carry the span taxonomy, and show the
        # pipeline's read/decode work overlapping query-thread
        # relax/wait time.
        from ..obs import MetricsRegistry, Tracer, validate_chrome_trace

        def mixed_serve(tracer, metrics=None):
            store = IndexStore(delta_dir,
                               cache=PageCache(budget25, policy="2q"))
            engine = StreamingQueryEngine(store, queue_depth=4,
                                          decode_workers=2, device=dev)
            srv = {m: QueryServer(engine, batch_size=8,
                                  cache_entries=0, mode=m,
                                  device=store.device, warm_start=True,
                                  tracer=tracer, metrics=metrics)
                   for m in ("ssd", "p2p")}
            answers = []
            try:
                for i, lo in enumerate(range(0, N_QUERIES, 8)):
                    if i % 2 == 0:
                        rs = srv["ssd"].serve_stream(sources[lo: lo + 8])
                    else:
                        rs = srv["p2p"].serve_stream(pairs[lo: lo + 8])
                    answers += [np.atleast_1d(r.dist) for r in rs]
            finally:
                engine.close()
            cs = store.cache.stats
            return answers, (cs.hits, cs.misses, cs.bytes_read,
                             cs.bytes_filled, cs.evictions)

        tracer = Tracer()
        metrics = MetricsRegistry()
        traced, ctr_traced = mixed_serve(tracer, metrics)
        plain, ctr_plain = mixed_serve(None)
        for a, b in zip(traced, plain):
            np.testing.assert_array_equal(a, b)
        assert ctr_traced == ctr_plain, \
            f"tracing perturbed the cache: {ctr_traced} != {ctr_plain}"
        for j in range(8):
            np.testing.assert_array_equal(traced[j], direct[j])
            np.testing.assert_array_equal(
                traced[8 + j],
                np.atleast_1d(np.float32(direct[8 + j][targets[8 + j]])))

        doc = tracer.chrome()
        problems = validate_chrome_trace(doc)
        assert not problems, f"invalid Chrome trace: {problems[:3]}"
        names = {e["name"] for e in doc["traceEvents"]}
        need = {"query.ssd", "query.p2p", "jit.dispatch", "pipe.submit",
                "level.wait", "level.relax", "level.read",
                "level.decode", "cache.hit", "cache.miss",
                "device.read"}
        assert need <= names, f"trace missing spans: {need - names}"
        sp = tracer.spans()
        pipe_sp = [s for s in sp
                   if s["name"] in ("level.read", "level.decode")
                   and s["tname"].startswith("hod-pipe-")]
        q_sp = [s for s in sp
                if s["name"] in ("level.relax", "level.wait")]
        assert pipe_sp and q_sp, "pipeline or query-thread spans missing"
        assert any(p["t0"] < q["t1"] and q["t0"] < p["t1"]
                   for p in pipe_sp for q in q_sp), \
            "no read/decode vs relax/wait overlap at queue depth 4"
        snap = metrics.snapshot()
        assert snap["schema_version"] >= 1
        for m in ("ssd", "p2p"):
            h = snap["histograms"][f"latency_ms.{m}"]
            assert h["count"] == 8 and 0.0 < h["p50"] <= h["p99"], \
                f"latency_ms.{m} histogram not sane: {h}"
        trace_out = os.environ.get("SMOKE_TRACE_OUT")
        if trace_out:
            tracer.write_chrome(trace_out)
            print(f"wrote {trace_out} "
                  f"({len(doc['traceEvents'])} events)")

        # Declarative-config end-to-end (DESIGN.md §12): the
        # checked-in mixed config drives a store-backed slo-scheduled
        # server — mixed ssd+p2p traffic under two SLO classes — and
        # every answer must stay bit-identical to a singleton call on
        # the in-memory engine (the unscheduled path).
        from ..config import SERVE_DEFAULTS, Config
        from ..launch.serve import mixed_request_stream, server_from_config

        cfg_path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__))))),
            "configs", "serve_mixed.yaml")
        cfg = Config(cfg_path if os.path.exists(cfg_path) else None,
                     defaults=SERVE_DEFAULTS,
                     overrides={"serve": {"requests": 48, "batch": 8}})
        if not cfg.get("serve.mix"):
            # installed tree without configs/: the same shape, inline
            cfg.data["serve"].update(
                scheduler="slo", mix={"ssd": 1, "p2p": 3},
                slo={"ssd": {"deadline_ms": 200.0},
                     "p2p": {"deadline_ms": 60.0, "batch": 8}})
        mixed_srv = server_from_config(cfg, store_path=store_dir,
                                       cache_bytes=budget25,
                                       engine_opts={"device": dev})
        assert mixed_srv.scheduler == "slo"
        assert set(mixed_srv.modes) == {"ssd", "p2p"}
        assert len(mixed_srv._slo) == 2, "expected two SLO classes"
        stream = mixed_request_stream(cfg, g.n,
                                      int(cfg.get("serve.requests")),
                                      np.random.default_rng(5))

        async def config_drive():
            tasks = [asyncio.create_task(mixed_srv.submit(*a, mode=m))
                     for m, a in stream]
            await asyncio.sleep(0)
            await mixed_srv.drain()
            return await asyncio.gather(*tasks)

        try:
            mixed_srv.warmup()
            mixed_answers = asyncio.run(config_drive())
        finally:
            mixed_srv.close()
        for (m, a), r in zip(stream, mixed_answers):
            if m == "p2p":
                np.testing.assert_array_equal(
                    r.dist, np.float32(eng_mem.p2p(
                        np.array([a[0]], np.int32),
                        np.array([a[1]], np.int32))[0]))
            else:
                np.testing.assert_array_equal(
                    r.dist, eng_mem.ssd(np.array(a, np.int32))[0])
        slo_rows = {r["cls"]: r for r in mixed_srv.slo_report()}
        assert {"ssd", "p2p"} <= set(slo_rows), \
            f"slo_report lost a traffic class: {sorted(slo_rows)}"
        assert slo_rows["p2p"]["deadline_ms"] == \
            cfg.get("serve.slo.p2p.deadline_ms")

        print(f"storage smoke OK on {dev}: {st.requests} queries from a "
              f"5% cache ({st.page_hit_rate():.1%} hit rate), "
              f"{st.store_bytes_read/1e6:.2f} MB actually read "
              f"({io.seq_blocks} seq / {io.rand_blocks} rand blocks), "
              f"{st25.page_hit_rate():.1%} hit rate at a 25% budget; "
              f"delta codec: segments {delta_seg/1e6:.2f} vs "
              f"{raw_seg/1e6:.2f} MB raw "
              f"({1 - delta_seg/raw_seg:.0%} smaller), "
              f"{std.store_bytes_read/1e6:.2f} vs "
              f"{st25.store_bytes_read/1e6:.2f} MB read, "
              f"hit rate {std.page_hit_rate():.1%}, "
              f"answers bit-identical to the in-memory engine; "
              f"depth-4 pipeline: bytes/hits identical to depth-1, "
              f"ttfl {st_d4.ttfl_seconds*1e3:.2f} ms; "
              f"knn(k=5): {len(knn_results)} queries bit-identical; "
              f"p2p: {stp.requests} pairs served "
              f"({stp.page_hit_rate():.1%} hit rate), cold sweep "
              f"{p2p_bytes/1e3:.0f} KB vs {ssd_bytes/1e3:.0f} KB full; "
              f"traced mixed serve bit-identical "
              f"({len(doc['traceEvents'])} trace events, "
              f"ssd p99 {snap['histograms']['latency_ms.ssd']['p99']:.1f}"
              f" ms); config-driven slo serve: {len(mixed_answers)} "
              f"mixed requests bit-identical "
              f"({'file ' + os.path.basename(cfg.path) if cfg.path else 'inline config'}, "
              f"p2p misses "
              f"{slo_rows['p2p']['deadline_misses']}"
              f"/{slo_rows['p2p']['requests']})")


if __name__ == "__main__":
    main()
