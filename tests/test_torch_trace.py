"""The port's tracer (DESIGN.md §11) and its hooks.

The ``Tracer`` cases of the JAX package's observability tests on the
port's copy; a tracer attached to a server is a pure observer (the same
answers and counters with it and without it, in memory and from a
store); an in-memory batch spans the engine's phases and the front
end's fan-out, and maps onto the wall clock; the port's store server
traces the same query-thread span sequence, the same ``submit``-track
cache instants and the same ``device``-track reads as the JAX store
server, at queue depths 1 and 4; and the serve CLI writes valid
``--trace-out`` / ``--metrics-out`` files.
"""
import dataclasses
import io
import json
import threading
from pathlib import Path

import numpy as np
import pytest

import repro.core as J
import repro.launch.serve as JS
import repro.obs as JO
import repro_torch.core as T
import repro_torch.launch.serve as TS
from repro_torch.obs import (SCHEMA_VERSION, MetricsRegistry, Tracer,
                             span_if, validate_chrome_trace)

_IX = {}


@pytest.fixture(scope="module")
def fixture_ix(tmp_path_factory):
    """(JAX index, the port's index, raw store path, delta store path)
    of one small weighted graph; the stores are written by the JAX
    package and read by both."""
    if not _IX:
        g = J.gnm_random_digraph(120, 480, seed=9, weighted=True)
        res = J.build_hod(g, J.BuildConfig(max_core_nodes=24,
                                           max_core_edges=512, seed=0))
        ixj = J.pack_index(g, res, chunk=64)
        root = tmp_path_factory.mktemp("trace")
        raw, delta = str(root / "raw"), str(root / "delta")
        ixj.save_store(raw, block_bytes=1024)
        ixj.save_store(delta, block_bytes=1024, codec="delta")
        buf = io.BytesIO()
        ixj.save(buf)
        buf.seek(0)
        with np.load(buf) as z:
            _IX["ix"] = (ixj, T.index_from_numpy(z), raw, delta)
    return _IX["ix"]


# ------------------------------------------------------------- the tracer
def test_tracer_spans_nest_and_sequence_is_shape_only():
    tr = Tracer()
    with tr.span("outer", plan="f"):
        with tr.span("inner", level=0):
            tr.instant("cache.hit", track="submit", block=3)
        tr.complete("wait", tr.now() - 1000, waiters=2)
    me = threading.current_thread().name
    assert tr.sequence(me) == [
        ("B", "outer", (("plan", "f"),)),
        ("B", "inner", (("level", 0),)),
        ("E", "inner", ()),
        ("X", "wait", (("waiters", 2),)),
        ("E", "outer", ()),
    ]
    sp = {s["name"]: s for s in tr.spans()}
    assert sp["outer"]["t0"] <= sp["inner"]["t0"] \
        and sp["inner"]["t1"] <= sp["outer"]["t1"]
    assert sp["wait"]["t1"] - sp["wait"]["t0"] >= 1000
    assert tr.sequence("submit") == [("i", "cache.hit", (("block", 3),))]
    tr.clear()
    assert tr.events() == []


def test_span_if_is_inert_when_off():
    with span_if(None, "anything", level=1):
        pass
    tr = Tracer()
    with span_if(tr, "x", track="t"):
        pass
    assert [e["ph"] for e in tr.events()] == ["B", "E"]
    assert tr.new_id() == 1 and tr.new_id() == 2


def test_chrome_export_validates_and_doctored_docs_fail():
    tr = Tracer()
    with tr.span("a"):
        with tr.span("b"):
            tr.instant("i1")
    tr.complete("x1", tr.now())
    doc = tr.chrome()
    assert validate_chrome_trace(doc) == []
    assert JO.validate_chrome_trace(doc) == []
    evs = [e for e in doc["traceEvents"] if e["ph"] != "M"]
    assert [e["name"] for e in evs if e["ph"] == "B"] == ["a", "b"]
    assert all(e["ph"] != "i" or e["s"] == "t" for e in evs)
    meta = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert meta and meta[0]["args"]["name"] == \
        threading.current_thread().name

    def doctor(mutate):
        d = json.loads(json.dumps(tr.chrome()))
        mutate(d["traceEvents"])
        got = validate_chrome_trace(d)
        assert got == JO.validate_chrome_trace(d)
        return got

    def last_e(evs):
        return next(i for i in range(len(evs) - 1, -1, -1)
                    if evs[i]["ph"] == "E")

    assert validate_chrome_trace({}) \
        == ["traceEvents missing or not a list"]
    assert doctor(lambda evs: evs[1].pop("ts"))          # missing field
    assert doctor(lambda evs: evs.pop(last_e(evs)))      # unbalanced B/E
    assert doctor(lambda evs: evs[last_e(evs)].update(
        name="zzz"))                                     # name mismatch
    assert doctor(lambda evs: evs[-1].update(ts=-1.0))   # ts backwards
    assert doctor(lambda evs: [e.pop("dur") for e in evs
                               if e["ph"] == "X"])       # X without dur
    assert doctor(lambda evs: evs.append(
        {"name": "q", "ph": "E", "pid": 1, "tid": 99,
         "ts": 1e12}))                                   # E without B


def test_jsonl_export_round_trips(tmp_path):
    tr = Tracer()
    with tr.span("a", k=1):
        tr.instant("i", track="t")
    p = tmp_path / "t.jsonl"
    tr.write_jsonl(str(p))
    lines = [json.loads(ln) for ln in p.read_text().splitlines()]
    assert [ln["ph"] for ln in lines] == ["B", "i", "E"]
    assert lines[0]["args"] == {"k": 1}
    assert lines[1]["tkey"] == ["track", "t"]


# ------------------------------------------------ the tracer only watches
def _requests(n, mode, count=14, seed=1):
    rng = np.random.default_rng(seed)
    src = rng.choice(n, size=count // 2, replace=False).astype(np.int32)
    src = np.concatenate([src, src[::-1]])               # repeats: hits
    return np.stack([src, src[::-1]], axis=1) if mode == "p2p" else src


def _counters(server):
    st = dataclasses.asdict(server.stats)
    for f in ("busy_seconds", "stall_seconds", "stall_wall_seconds",
              "ttfl_seconds"):
        st.pop(f)
    snap = server.metrics.snapshot()["counters"]
    snap = {k: v for k, v in snap.items()
            if "seconds" not in k}
    out = {"stats": st, "counters": snap,
           "io": dataclasses.astuple(server.modeled_io())}
    if server.store is not None:
        out["cache"] = dataclasses.astuple(server.store.cache.stats)
    return out


def _serve(ixt, store, tracer, mode, depth=4):
    kw = dict(batch_size=4, cache_entries=8, mode=mode, within_d=6.0,
              knn_k=4, tracer=tracer, metrics=MetricsRegistry())
    if store is None:
        server = TS.QueryServer(T.QueryEngine(ixt, device="cpu"),
                                warm_start=True, **kw)
    else:
        server = TS.QueryServer(store_path=store, cache_bytes=6000,
                                queue_depth=depth,
                                engine_opts={"device": "cpu"},
                                warm_start=True, **kw)
    try:
        res = server.serve_stream(_requests(ixt.n, mode))
        return res, _counters(server)
    finally:
        server.close()


@pytest.mark.parametrize("where", ["memory", "raw", "delta"])
@pytest.mark.parametrize("mode", ["ssd", "sssp", "p2p", "within", "knn"])
def test_tracer_is_a_pure_observer(fixture_ix, mode, where):
    _, ixt, raw, delta = fixture_ix
    store = {"memory": None, "raw": raw, "delta": delta}[where]
    tr = Tracer()
    traced, c_traced = _serve(ixt, store, tr, mode)
    plain, c_plain = _serve(ixt, store, None, mode)
    for a, b in zip(traced, plain):
        assert (a.source, a.target, a.cached, a.batched_with) \
            == (b.source, b.target, b.cached, b.batched_with)
        for f in ("dist", "pred", "nodes"):
            if getattr(b, f) is not None:
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert c_traced == c_plain
    assert c_traced["stats"]["cache_hits"] > 0
    assert validate_chrome_trace(tr.chrome()) == []
    names = {e["name"] for e in tr.events()}
    assert {f"query.{mode}", "jit.dispatch"} <= names
    if store is not None:
        assert {"core.search", "cache.miss", "device.read"} <= names
        assert "level.read" in names
        if mode in ("ssd", "sssp"):
            assert {"pipe.submit", "level.wait", "level.relax"} <= names
        if where == "delta" and mode in ("ssd", "sssp"):
            assert "level.decode" in names
    else:
        assert not {"level.relax", "core.search"} & names


# ------------------------------------------ the port's in-memory spans
_PHASES = {"ssd": ["phase.forward", "phase.core", "phase.backward",
                   ("phase.to_host", "dist")],
           "sssp": ["phase.forward", "phase.core", "phase.backward",
                    "phase.recon", ("phase.to_host", "dist"),
                    ("phase.to_host", "pred")]}


@pytest.mark.parametrize("mode", ["ssd", "sssp"])
def test_in_memory_batch_spans_its_phases_and_front_end(fixture_ix, mode):
    """Each async batch of an in-memory server: the coalesce wait, the
    engine's phases in order inside ``jit.dispatch`` (one
    ``phase.to_host`` an answer copied), then the front end's
    ``server.rows`` and ``server.resolve``, once each."""
    import asyncio
    _, ixt, _, _ = fixture_ix
    tr = Tracer()
    engine = T.QueryEngine(ixt, device="cpu")
    server = TS.QueryServer(engine, batch_size=4, max_wait_ms=5.0,
                            cache_entries=0, mode=mode, warm_start=True,
                            tracer=tr)

    async def drive():
        tasks = [asyncio.create_task(server.submit(s)) for s in range(10)]
        await server.drain()
        return await asyncio.gather(*tasks)

    assert len(asyncio.run(drive())) == 10
    batches = server.stats.batches
    assert batches == 3
    inner = []
    for p in _PHASES[mode]:
        name, what = p if isinstance(p, tuple) else (p, None)
        attrs = (("what", what),) if what else ()
        inner += [("B", name, attrs), ("E", name, ())]
    want = []
    for batch, fill in enumerate((4, 4, 2), 1):
        want += ([("X", "coalesce.wait", (("waiters", fill),)),
                  ("B", f"query.{mode}", (("batch", batch), ("fill", fill))),
                  ("B", "jit.dispatch", (("mode", mode),))] + inner
                 + [("E", "jit.dispatch", ()), ("E", f"query.{mode}", ()),
                    ("B", "server.rows", ()), ("E", "server.rows", ()),
                    ("B", "server.resolve", ()),
                    ("E", "server.resolve", ())])
    got = tr.sequence(threading.current_thread().name)
    assert got == want
    assert validate_chrome_trace(tr.chrome()) == []
    server.close()


def test_mapped_span_lies_between_wall_clock_readings():
    """A span's bounds on the wall clock (``to_epoch_ns``) lie between two
    ``time.time_ns()`` readings taken around it; ``chrome()`` carries
    the mapping."""
    import time
    tr = Tracer()
    a = time.time_ns()
    with tr.span("x"):
        time.sleep(0.002)
    b = time.time_ns()
    (sp,) = tr.spans()
    assert sp["ph"] == "B"
    assert a <= tr.to_epoch_ns(sp["t0"]) <= tr.to_epoch_ns(sp["t1"]) <= b
    assert tr.to_epoch_ns(sp["t1"]) - tr.to_epoch_ns(sp["t0"]) >= 2_000_000
    assert tr.chrome()["otherData"] == {"epoch_ns": tr.epoch_ns}


# ------------------------------------- the two packages trace alike
def _store_server(pkg, path, mode, depth, tracer):
    kw = dict(store_path=path, cache_bytes=6000, batch_size=4,
              cache_entries=8, mode=mode, within_d=6.0, knn_k=4,
              queue_depth=depth, tracer=tracer, warm_start=True)
    if pkg is TS:
        kw["engine_opts"] = {"device": "cpu"}
    return pkg.QueryServer(**kw)


def _sequences(pkg, tracer, path, mode, depth):
    me = threading.current_thread().name
    tr = tracer()
    server = _store_server(pkg, path, mode, depth, tr)
    try:
        reqs = _requests(server.engine.index.n, mode)
        server.serve_stream(reqs)
        server.serve_stream(reqs[:5])      # warm rows: hit-path events
        assert validate_chrome_trace(tr.chrome()) == []
        return (tr.sequence(me), tr.sequence("submit"),
                tr.sequence("device"))
    finally:
        server.close()


@pytest.mark.parametrize("mode", ["ssd", "sssp", "p2p", "within"])
@pytest.mark.parametrize("codec", ["raw", "delta"])
def test_store_trace_sequences_match_jax(fixture_ix, codec, mode):
    _, _, raw, delta = fixture_ix
    path = raw if codec == "raw" else delta
    got = {d: _sequences(TS, Tracer, path, mode, d) for d in (1, 4)}
    want = {d: _sequences(JS, JO.Tracer, path, mode, d) for d in (1, 4)}
    for d in (1, 4):
        assert got[d][0], "no query-thread events traced"
        assert got[d][1], "no submit-track events traced"
        assert got[d][0] == want[d][0], f"query thread, depth {d}"
        assert got[d][1] == want[d][1], f"submit track, depth {d}"
        assert got[d][2] == want[d][2], f"device track, depth {d}"
    assert got[1] == got[4], "queue depth changed the traced sequence"


def test_pipeline_spans_stitch_across_threads(fixture_ix):
    """Every level's io-thread read, decode-pool decodes and query-thread
    wait carry the span id its ``pipe.submit`` drew."""
    _, _, _, delta = fixture_ix
    tr = Tracer()
    server = _store_server(TS, delta, "ssd", 4, tr)
    try:
        server.serve_stream(_requests(server.engine.index.n, "ssd"))
    finally:
        server.close()
    evs = [e for e in tr.events() if e["ph"] == "B"]
    submitted = {e["args"]["span"] for e in evs
                 if e["name"] == "pipe.submit"}
    waits = {e["args"]["span"] for e in evs if e["name"] == "level.wait"}
    reads = [e for e in evs if e["name"] == "level.read"]
    decodes = [e for e in evs if e["name"] == "level.decode"]
    assert submitted and waits == submitted
    assert reads and {e["args"]["parent"] for e in reads} <= submitted
    assert decodes and {e["args"]["parent"] for e in decodes} <= submitted
    assert {e["tname"] for e in reads} != {threading.current_thread().name}


def test_async_batches_trace_coalesce_wait(fixture_ix):
    import asyncio
    _, ixt, _, _ = fixture_ix
    tr, reg = Tracer(), MetricsRegistry()
    server = TS.QueryServer(T.QueryEngine(ixt, device="cpu"), batch_size=4,
                            max_wait_ms=5.0, cache_entries=0,
                            warm_start=True, tracer=tr, metrics=reg)

    async def drive():
        tasks = [asyncio.create_task(server.submit(s)) for s in range(4)]
        await server.drain()
        return await asyncio.gather(*tasks)

    assert len(asyncio.run(drive())) == 4
    waits = [e for e in tr.events() if e["name"] == "coalesce.wait"]
    assert waits and all(e["ph"] == "X" and e["dur"] >= 0 for e in waits)
    assert waits[0]["args"]["waiters"] == 4
    assert reg.histogram("coalesce_wait_ms").count == len(waits)
    assert validate_chrome_trace(tr.chrome()) == []


# ------------------------------------------------------------------ CLI
@pytest.mark.parametrize("store", [False, True])
def test_cli_writes_trace_and_metrics(tmp_path, monkeypatch, store):
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    out = tmp_path / "out"
    out.mkdir()
    chrome, flat, metrics = (str(out / "t.json"), str(out / "t.jsonl"),
                             str(out / "m.json"))
    argv = ["--side", "12", "--requests", "24", "--batch", "4",
            "--device", "cpu", "--config",
            str(Path(__file__).resolve().parent.parent / "configs"
                / "serve_mixed.yaml")]
    if store:
        argv += ["--store", "--cache-frac", "0.25"]
    TS.main(argv + ["--trace-out", chrome, "--metrics-out", metrics])
    doc = json.loads(open(chrome).read())
    assert validate_chrome_trace(doc) == []
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"query.ssd", "query.p2p", "jit.dispatch",
            "coalesce.wait"} <= names
    if store:
        assert {"pipe.submit", "level.relax", "core.search"} <= names
    snap = json.loads(open(metrics).read())
    assert snap["schema_version"] == SCHEMA_VERSION
    assert snap["counters"]["server.requests"] == 24
    assert snap["histograms"]["latency_ms.p2p"]["count"] > 0
    TS.main(argv + ["--trace-out", flat])
    lines = [json.loads(ln) for ln in open(flat).read().splitlines()]
    assert lines and {"ph", "name", "ts", "tkey"} <= set(lines[0])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["out"]
