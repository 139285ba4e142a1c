"""The port's paper baselines and reference builder against the JAX
package's.

``em_dijkstra``, ``em_bfs`` and ``VCIndex`` (the paper's EM-Dijk,
EM-BFS and VC-Index, §7) are host code in both packages: on the same
graph they give the same distances and meter the same ``IOStats``.
The dict-based ``build_hod`` draws from ``default_rng(cfg.seed)`` in
the same order, so its ``BuildResult`` equals the JAX one field for
field (wall time aside), and ``pack_index`` of it writes the JAX
package's ``.npz`` key roster with equal arrays.
"""
import dataclasses
import io

import numpy as np
import pytest

import repro.core as J
import repro_torch.core as T
from repro.core import baselines as JB
from repro_torch.core import baselines as TB

GRAPHS = {
    "gnm150": lambda m: m.gnm_random_digraph(150, 600, seed=4,
                                             weighted=True),
    "grid12": lambda m: m.grid_road_graph(12, seed=1),
    "powerlaw300": lambda m: m.power_law_digraph(300, 3, seed=2,
                                                 weighted=True),
}
UNDIRECTED = {
    "und150": lambda m: m.symmetrize(m.gnm_random_digraph(150, 400,
                                                          seed=3)),
    # the reference's greedy matching covers all but one node of an
    # odd grid (an even one it covers whole: no level at all)
    "grid13": lambda m: m.symmetrize(m.grid_road_graph(13, seed=1)),
    "powerlaw300": lambda m: m.symmetrize(m.power_law_digraph(
        300, 2, seed=2, weighted=True)),
}


def _io(stats):
    return dataclasses.asdict(stats)


# ------------------------------------------------------------ baselines
@pytest.mark.parametrize("cache_blocks", [8, 4096])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_em_dijkstra_equals_the_references(name, cache_blocks):
    gj, gt = GRAPHS[name](J), GRAPHS[name](T)
    for s in (0, 7, gt.n - 1):
        dj, ioj = JB.em_dijkstra(gj, s, cache_blocks=cache_blocks)
        dt, iot = TB.em_dijkstra(gt, s, cache_blocks=cache_blocks)
        np.testing.assert_array_equal(dt, dj)
        assert _io(iot) == _io(ioj) and iot.rand_blocks > 0


@pytest.mark.parametrize("block_bytes", [256, 65536])
def test_em_bfs_equals_the_references(block_bytes):
    from repro.core.io_sim import BlockDevice as JDev
    from repro_torch.core.io_sim import BlockDevice as TDev
    gj = J.symmetrize(J.gnm_random_digraph(120, 360, seed=5,
                                           weighted=False))
    gt = T.symmetrize(T.gnm_random_digraph(120, 360, seed=5,
                                           weighted=False))
    for s in (0, 60):
        dj, ioj = JB.em_bfs(gj, s, device=JDev(block_bytes=block_bytes))
        dt, iot = TB.em_bfs(gt, s, device=TDev(block_bytes=block_bytes))
        np.testing.assert_array_equal(dt, dj)
        assert _io(iot) == _io(ioj)
    oracle = T.dijkstra_reference(gt, [0])[0]
    finite = np.isfinite(oracle)
    np.testing.assert_array_equal(dt[finite] >= 0, True)


@pytest.mark.parametrize("top_nodes", [16, 64])
@pytest.mark.parametrize("name", sorted(UNDIRECTED))
def test_vc_index_equals_the_references(name, top_nodes):
    gj, gt = UNDIRECTED[name](J), UNDIRECTED[name](T)
    vj, vt = JB.VCIndex(gj, top_nodes=top_nodes), \
        TB.VCIndex(gt, top_nodes=top_nodes)
    assert len(vt.levels) == len(vj.levels) > 0
    for a, b in zip(vt.levels, vj.levels):
        np.testing.assert_array_equal(a.removed, b.removed)
        assert (a.adj, a.nbytes) == (b.adj, b.nbytes)
    np.testing.assert_array_equal(vt.top_nodes_ids, vj.top_nodes_ids)
    assert vt.top_adj == vj.top_adj
    assert vt.index_bytes() == vj.index_bytes()
    assert _io(vt.build_io) == _io(vj.build_io)
    oracle = T.dijkstra_reference(gt, [0, 5])
    for i, s in enumerate((0, 5)):
        dj, ioj = vj.ssd(s)
        dt, iot = vt.ssd(s)
        np.testing.assert_array_equal(dt, dj)
        assert _io(iot) == _io(ioj)
        finite = np.isfinite(oracle[i])
        np.testing.assert_allclose(dt[finite], oracle[i][finite],
                                   rtol=1e-5)


# ------------------------------------------------------- the builder
def _assert_build_equal(rt, rj):
    for f in dataclasses.fields(rj):
        a, b = getattr(rt, f.name), getattr(rj, f.name)
        if f.name == "stats":
            sa, sb = dataclasses.asdict(a), dataclasses.asdict(b)
            sa.pop("build_seconds"), sb.pop("build_seconds")
            assert sa == sb
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def _build_both(name, seed, core=(32, 1024)):
    gj, gt = GRAPHS[name](J), GRAPHS[name](T)
    rj = J.build_hod(gj, J.BuildConfig(max_core_nodes=core[0],
                                       max_core_edges=core[1], seed=seed))
    rt = T.build_hod(gt, T.BuildConfig(max_core_nodes=core[0],
                                       max_core_edges=core[1], seed=seed))
    return gj, gt, rj, rt


@pytest.mark.parametrize("seed", [0, 1, 5])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_build_hod_equals_the_references(name, seed):
    """Every field of the BuildResult (ranks, removal order, level
    sizes, the F_f/F_b adjacency snapshots, the core graph) and every
    BuildStats counter, the metered I/O included."""
    _, _, rj, rt = _build_both(name, seed)
    assert rt.stats.rounds > 0 and rt.stats.shortcuts_added >= 0
    _assert_build_equal(rt, rj)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_pack_of_build_hod_writes_the_references_roster(name):
    """``pack_index`` of the port's ``build_hod`` result saves the JAX
    package's ``.npz`` key roster with equal arrays, and answers as
    Dijkstra does."""
    gj, gt, rj, rt = _build_both(name, 0)
    ixj = J.pack_index(gj, rj, chunk=64)
    ixt = T.pack_index(gt, rt, chunk=64, device="cpu")
    bufs = []
    for ix in (ixj, ixt):
        buf = io.BytesIO()
        ix.save(buf)
        buf.seek(0)
        bufs.append(buf)
    with np.load(bufs[0]) as zj, np.load(bufs[1]) as zt:
        assert sorted(zt.files) == sorted(zj.files)
        for k in zj.files:
            assert zt[k].dtype == zj[k].dtype, k
            np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
    srcs = np.array([0, 3, gt.n - 1], np.int32)
    np.testing.assert_array_equal(
        T.QueryEngine(ixt, device="cpu").ssd(srcs),
        T.dijkstra_reference(gt, srcs))
