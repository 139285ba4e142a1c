"""The HoD batch split (``--data-parallel``) against the unsharded port
and the JAX package's unmapped engines and server.

One gloo group a world size (1 to 4; 3 splits the batch of 8 unevenly)
runs every case under ``axis_rules(mesh, {"batch": "data"})``
(``torchdist_bodies.hod_battery``): the in-memory engine and the
store-backed one (raw and delta at 25%; queue depth 4 in every mode,
depth 1 in the full sweeps, the only ones its read pipeline serves),
``ssd_bounded`` and top-k closeness, ``serve_stream``, and the
async front end under fifo and slo on a frozen clock.  Sources are
independent, so every rank's answers must equal the unsharded engine's
and JAX's bit for bit, and each rank's page-cache and I/O counters the
unsharded store run's (a bounded sweep's decisions are the whole
batch's).  One case runs the serve CLI under ``torchrun`` on 2 ranks.
"""
import asyncio
import contextlib
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import repro.core as J
import repro.launch.serve as JS
import repro.storage as JST
from repro.config import Config as JConfig
from repro_torch.config import SERVE_DEFAULTS, Config
from repro_torch.launch import serve as tserve
import torchdist

SRC = np.array([0, 3, 77, 149, 3, 60, 12, 101], np.int32)
TGT = np.array([5, 140, 0, 60, 99, 60, 12, 7], np.int32)
MIX = {"batch": 8, "max_wait_ms": 5000.0,
       "mix": {"ssd": 1, "p2p": 3, "within": 1},
       "threshold": 6.0, "cache_entries": 24,
       "slo": {"p2p": {"deadline_ms": 5000.0, "batch": 4},
               "ssd": {"deadline_ms": 20000.0}}}
MODES = ("ssd", "sssp", "p2p", "within", "knn")
CLI_ARGV = ("--device", "cpu", "--side", "12", "--requests", "40",
            "--batch", "8")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with torchdist.one_thread():
        yield


@pytest.fixture(scope="module")
def payload(tmp_path_factory):
    """The JAX storage tests' index, as an ``.npz`` and as raw and delta
    stores (written by the JAX package), and the payload every rank
    gets; the bounded sweeps' thresholds from the port's farness (equal
    to JAX's, which ``setup`` holds it to), so no JAX compile waits
    before the ranks start."""
    from repro_torch import core as T
    tmp = tmp_path_factory.mktemp("dp")
    g = J.gnm_random_digraph(150, 600, seed=4, weighted=True)
    res = J.build_hod(g, J.BuildConfig(max_core_nodes=32,
                                       max_core_edges=1024, seed=0))
    ixj = J.pack_index(g, res, chunk=64)
    npz = str(tmp / "index.npz")
    ixj.save(npz)
    stores = {}
    for codec in ("raw", "delta"):
        stores[codec] = str(tmp / codec)
        ixj.save_store(stores[codec], block_bytes=1024, codec=codec)
    with np.load(npz) as z:
        d = T.QueryEngine(T.index_from_numpy(z), device="cpu").ssd(SRC)
    far = np.where(np.isfinite(d), d, 0.0).sum(axis=1)
    cfg = Config(None, defaults=SERVE_DEFAULTS, overrides={"serve": MIX})
    p = {"npz": npz, "stores": stores, "src": SRC, "tgt": TGT, "d": 6.0,
         "k": 5, "bounded_src": SRC[far > 0],
         "thresholds": [0.0, 0.5 * float(far[far > 0].min()), 1e30],
         "topk_store": ("raw", 4), "topk_k": 5, "batch": 8,
         "topk_cand": np.arange(1, 150, 2, dtype=np.int32)[:32],
         "requests": np.random.default_rng(3).integers(0, 150, 30)
         .astype(np.int32) // 2,
         "mix": MIX,
         "mixed": tserve.mixed_request_stream(
             cfg, ixj.n, 90, np.random.default_rng(5), p2p_pool=6)}
    return p, ixj


@pytest.fixture(scope="module")
def spawned(payload):
    """One gloo group a world size, each spawned on its own and all at
    once (the ranks wait on each other more than they compute), before
    JAX's references are computed; the group of one also runs the
    unsharded port.  Each is collected by the first case that needs
    it."""
    ranks = {w: torchdist.Ranks(w, "torchdist_bodies:hod_battery",
                                payload[0], timeout=180.0)
             for w in (4, 3, 2, 1)}
    yield ranks
    for r in ranks.values():
        r.close()


@pytest.fixture(scope="module")
def cli_run(payload, tmp_path_factory):
    """The serve CLI under ``torchrun`` on 2 CPU ranks, started with the
    ranks above and read by its case (output to files: nothing waits on
    a full pipe)."""
    tmp = tmp_path_factory.mktemp("cli")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    with open(tmp / "out", "w") as out, open(tmp / "err", "w") as err:
        run = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
             "--data-parallel", *CLI_ARGV],
            stdout=out, stderr=err, text=True, env=env, cwd=REPO)
    run.out, run.err = tmp / "out", tmp / "err"
    yield run
    if run.poll() is None:
        run.kill()
        run.wait()


@pytest.fixture(scope="module")
def setup(payload, spawned, cli_run):
    """The payload, JAX's answers and the unsharded port's results."""
    p, ixj = payload
    want = _jax_results(ixj, p)
    return p, want, spawned[1].results()[0]["ref"]


def _jax_results(ixj, p):
    """The JAX package's unmapped answers to every case: engine modes,
    a completed bounded sweep, top-k closeness in memory and from the
    raw store, ``serve_stream`` and the async front end."""
    eng = J.QueryEngine(ixj)
    out = {"ssd": eng.ssd(p["src"]), "sssp": eng.sssp(p["src"]),
           "p2p": eng.p2p(p["src"], p["tgt"]),
           "within": eng.ssd_within(p["src"], p["d"]),
           "knn": eng.knn(p["src"], p["k"])}
    # sources are independent: the bounded sources' rows of ssd(SRC)
    out["bounded"] = out["ssd"][np.isin(p["src"], p["bounded_src"])]
    path = p["stores"]["raw"]
    budget = int(0.25 * JST.segment_logical_bytes(path))
    store = JST.StreamingQueryEngine(
        JST.IndexStore(path, cache=JST.PageCache(budget, policy="2q")))
    try:
        for name, e in (("memory", eng), (("raw", 4), store)):
            tk = J.topk_closeness(e, k=p["topk_k"],
                                  candidates=p["topk_cand"],
                                  batch_size=p["batch"])
            out["topk", name] = (tk.nodes, tk.closeness, tk.farness, tk.k,
                                 tk.batches, tk.pruned)
    finally:
        store.close()
    sj = JS.QueryServer(eng, batch_size=p["batch"], cache_entries=24)
    sj.warmup()
    out["stream"] = (_jax_rows(sj.serve_stream(p["requests"])),
                     _jax_counts(sj))
    for scheduler in ("fifo", "slo"):
        out["async", scheduler] = _jax_async(eng, p, scheduler)
    return out


def _jax_rows(results):
    return [(r.mode, r.source, r.target, r.cached, r.batched_with,
             r.io_bytes, r.dist, r.pred, getattr(r, "nodes", None))
            for r in results]


def _jax_counts(server):
    st = server.stats
    return (st.requests, st.cache_hits, st.padded_slots, st.batches)


def _jax_async(eng, p, scheduler):
    """The mixed stream through JAX's server on a frozen clock, in
    chunks of 7 (as ``torchdist_bodies._serve_async``)."""
    over = {"serve": dict(MIX, scheduler=scheduler)}
    sj = JS.server_from_config(
        JConfig(None, defaults=JS.SERVE_DEFAULTS, overrides=over),
        engine=eng)
    sj.warmup()
    sj._now = lambda: 0.0

    async def drive():
        tasks = []
        for lo in range(0, len(p["mixed"]), 7):
            tasks += [asyncio.create_task(sj.submit(*a, mode=m))
                      for m, a in p["mixed"][lo:lo + 7]]
            await asyncio.sleep(0)
        await sj.drain()
        return await asyncio.gather(*tasks)
    rows = _jax_rows(asyncio.run(drive()))
    return rows, _jax_counts(sj), sj.metrics.snapshot()["counters"]


@pytest.fixture(scope="module", params=[1, 2, 3, 4])
def world(request, setup, spawned):
    w = request.param
    return w, [out[w] for out in spawned[w].results()]


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("engine", ["memory", ("raw", 1), ("raw", 4),
                                    ("delta", 1), ("delta", 4)],
                         ids=str)
def test_engine_split_matches_unsharded_and_jax(setup, world, engine):
    p, want, ref = setup
    for out in world[1]:
        got = out[engine]
        _equal(got, ref[engine])         # answers, stats after each call
        modes = MODES[:2] if engine in (("raw", 1), ("delta", 1)) else MODES
        assert set(modes) <= set(got)
        for m in modes:
            _equal(got[m], want[m])


def test_bounded_sweeps_prune_as_unsharded(setup, world):
    """``ssd_bounded`` on the sources that reach something: the split
    prunes where the unsharded engine does (held with every call in
    the test above), here at least one threshold prunes, and the
    loosest completes with SSD's answer."""
    p, want, ref = setup
    for out in world[1]:
        for codec in ("raw", "delta"):
            got = [out[codec, 4][f"bounded{t}"] for t in p["thresholds"]]
            assert any(not done for _, done in got) and got[-1][1]
            np.testing.assert_array_equal(got[-1][0], want["bounded"])


@pytest.mark.parametrize("engine", ["memory", ("raw", 4)], ids=str)
def test_topk_closeness_matches_jax(setup, world, engine):
    p, want, ref = setup
    for out in world[1]:
        _equal(out[engine]["topk"], want["topk", engine])


def test_serve_stream_matches_jax(setup, world):
    p, want, ref = setup
    for out in world[1]:
        rows, (counts, counters) = out["stream"]
        _equal(rows, want["stream"][0])
        assert counts == want["stream"][1]
        _equal(out["stream"], ref["stream"])


@pytest.mark.parametrize("scheduler", ["fifo", "slo"])
def test_async_front_end_matches_jax(setup, world, scheduler):
    p, want, ref = setup
    rows_j, counts_j, jc = want["async", scheduler]
    for out in world[1]:
        rows, (counts, counters) = out["async", scheduler]
        _equal(rows, rows_j)
        assert counts == counts_j
        assert counters == {k: v for k, v in jc.items() if k in counters}
        assert {k for k in counters if k.startswith("slo.requests")} == \
            {k for k in jc if k.startswith("slo.requests")}
        _equal(out["async", scheduler], ref["async", scheduler])


_REPORT = re.compile(r"^(served .*|modeled disk: .*)$", re.M)


def test_cli_under_torchrun_reports_as_unsharded(cli_run):
    """``torchrun`` on 2 CPU ranks: rank 0's report (requests, batches,
    cache hits, padded slots, modeled disk) equals the unsharded run's."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tserve.main(list(CLI_ARGV))
    want = _REPORT.findall(buf.getvalue())
    cli_run.wait(timeout=120)
    out, err = cli_run.out.read_text(), cli_run.err.read_text()
    assert cli_run.returncode == 0, err[-3000:]
    assert "data-parallel over 2 rank(s)" in out
    assert len(want) == 2 and _REPORT.findall(out) == want
