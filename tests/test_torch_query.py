"""The port's QueryEngine (on the CPU) against the JAX package's.

Both engines get the same index: the JAX package packs it, and the port
reads its ``.npz`` key roster through ``index_from_numpy``.  Every query
method, in all three core modes, must return bit-identical answers
(``assert_array_equal``): every operation on the HoD path is an fp32
add, a min or a max.  The JAX engine runs with ``use_pallas`` off and,
on the small grid, on (Pallas interpret mode).  The port also answers
the Dijkstra oracle exactly on integer weights.
"""
import io

import numpy as np
import pytest

import repro.core as J
import repro_torch.core as T
from oracle import ShortestPathOracle
from repro.core.build_fast import build_hod_fast as jax_build_hod_fast


def _float_weight_graph(m):
    rng = np.random.default_rng(11)
    n = 120
    src, dst = rng.integers(0, n, 600), rng.integers(0, n, 600)
    return m.from_edges(n, src, dst, rng.uniform(0.5, 5.0, 600))


GRAPHS = {
    "grid10": lambda m: m.grid_road_graph(10, seed=4),
    "gnm150": lambda m: m.gnm_random_digraph(150, 600, seed=9),
    "powerlaw200": lambda m: m.power_law_digraph(200, 3, seed=5,
                                                 weighted=True),
    "floatw120": _float_weight_graph,
}
_BUNDLES = {}


def bundle(name):
    """(graph, JAX index, the port's index read from its .npz roster)."""
    if name not in _BUNDLES:
        g = GRAPHS[name](J)
        res = jax_build_hod_fast(g, J.BuildConfig(max_core_nodes=32,
                                                  max_core_edges=1024))
        ixj = J.pack_index(g, res, chunk=64)
        buf = io.BytesIO()
        ixj.save(buf)
        buf.seek(0)
        with np.load(buf) as z:
            ixt = T.index_from_numpy(z)
        _BUNDLES[name] = (g, ixj, ixt)
    return _BUNDLES[name]


def _queries(n, seed):
    rng = np.random.default_rng(seed)
    sources = rng.integers(0, n, 5).astype(np.int32)
    sources[-1] = sources[0]                     # a repeated source
    targets = rng.integers(0, n, 5).astype(np.int32)
    return sources, targets


CASES = [(name, mode, pallas)
         for name in ("grid10", "gnm150", "powerlaw200")
         for mode in ("closure", "bellman", "dijkstra")
         for pallas in ((False, True) if name == "grid10" else (False,))]


@pytest.mark.parametrize("name,core_mode,use_pallas", CASES)
def test_queries_match_jax(name, core_mode, use_pallas):
    g, ixj, ixt = bundle(name)
    ej = J.QueryEngine(ixj, core_mode=core_mode, use_pallas=use_pallas)
    et = T.QueryEngine(ixt, core_mode=core_mode, device="cpu")
    assert et.core_mode == ej.core_mode
    src, tgt = _queries(g.n, seed=len(name))
    np.testing.assert_array_equal(et.ssd(src), ej.ssd(src))
    dt, pt = et.sssp(src)
    dj, pj = ej.sssp(src)
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(et.p2p(src, tgt), ej.p2p(src, tgt))
    for d in (4.0, 9.5):
        np.testing.assert_array_equal(et.ssd_within(src, d),
                                      ej.ssd_within(src, d))
    for a, b in zip(et.knn(src, 7), ej.knn(src, 7)):
        np.testing.assert_array_equal(a, b)
    assert et.paths(src, tgt) == ej.paths(src, tgt)


@pytest.mark.parametrize("name", ["grid10", "gnm150", "powerlaw200"])
def test_port_matches_dijkstra_oracle(name):
    """Integer weights: every distance is exact, so the port's f32
    sweeps equal the oracle's f64 heap bit for bit."""
    g, _, ixt = bundle(name)
    orc = ShortestPathOracle(g)
    eng = T.QueryEngine(ixt, device="cpu")
    src, tgt = _queries(g.n, seed=3)
    dist, pred = eng.sssp(src)
    p2p = eng.p2p(src, tgt)
    within = eng.ssd_within(src, 6.0)
    nodes, kd = eng.knn(src, 6)
    for i, s in enumerate(src.tolist()):
        np.testing.assert_array_equal(dist[i], orc.ssd(s))
        orc.check_sssp(s, dist[i], pred[i])
        assert p2p[i] == orc.p2p(s, int(tgt[i]))
        np.testing.assert_array_equal(within[i], orc.within(s, 6.0))
        want_nodes, want_d = orc.knn(s, 6)
        np.testing.assert_array_equal(nodes[i], want_nodes)
        np.testing.assert_array_equal(kd[i], want_d)
    np.testing.assert_array_equal(
        T.dijkstra_reference(T.grid_road_graph(6), [0, 7]),
        J.dijkstra_reference(J.grid_road_graph(6), [0, 7]))


@pytest.mark.parametrize("eps", [1e-3, 0.05, 0.2])
def test_sssp_eps_matches_jax(eps):
    """``eps > 0`` widens the tight-edge test (``cand <= tgt + eps *
    (1 + tgt)``) on non-integer weights; the port computes it with the
    same unfused f32 multiply and add, so the predecessors agree."""
    g, ixj, ixt = bundle("floatw120")
    src, _ = _queries(g.n, seed=8)
    dj, pj = J.QueryEngine(ixj, eps=eps).sssp(src)
    dt, pt = T.QueryEngine(ixt, eps=eps, device="cpu").sssp(src)
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(pt, pj)


def test_closure_skipped_serves_in_bellman_mode():
    g = T.gnm_random_digraph(150, 600, seed=9)
    res = T.build_hod_fast(g, T.BuildConfig(max_core_nodes=32,
                                            max_core_edges=1024))
    ix = T.pack_index(g, res, chunk=64, closure_limit=4, device="cpu")
    eng = T.QueryEngine(ix, device="cpu")
    assert eng.core_mode == "bellman"
    src, _ = _queries(g.n, seed=1)
    np.testing.assert_array_equal(eng.ssd(src),
                                  T.dijkstra_reference(g, src))


def test_engine_rejects_bad_arguments():
    _, _, ixt = bundle("gnm150")
    with pytest.raises(ValueError):
        T.QueryEngine(ixt, core_mode="floyd", device="cpu")
    with pytest.raises(ValueError):
        T.QueryEngine(ixt, device="meta")
    eng = T.QueryEngine(ixt, device="cpu")
    with pytest.raises(ValueError):
        eng.knn(np.array([0], np.int32), 0)
    with pytest.raises(IndexError):
        eng.ssd(np.array([ixt.n], np.int32))
