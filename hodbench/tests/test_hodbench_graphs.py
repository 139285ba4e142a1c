"""The frozen generators: a seed gives the same arcs every time, and the
structure is the port's generator's."""
import numpy as np
import pytest

from hodbench import spec
from hodbench.tests.support import ROOT

from repro_torch.core.graph import (from_edges, grid_road_graph,
                                    power_law_digraph)


def _edges(kind, params, seed):
    gen = spec.load_module(ROOT / "hodbench" / "graphs" / f"{kind}.py")
    return gen.edges(params, np.random.default_rng(seed))


PARAMS = {"grid_road": {"side": 9, "weight_min": 1, "weight_max": 10000},
          "power_law": {"n": 150, "m_per_node": 4, "weight_min": 1,
                        "weight_max": 10000}}


@pytest.mark.parametrize("kind", sorted(PARAMS))
def test_seed_gives_same_arrays(kind):
    a = _edges(kind, PARAMS[kind], 2 ** 31 + 7)
    b = _edges(kind, PARAMS[kind], 2 ** 31 + 7)
    c = _edges(kind, PARAMS[kind], 2 ** 31 + 8)
    assert a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[3], c[3])
    w = a[3]
    assert w.min() >= 1 and w.max() <= 10000 and np.all(w == np.round(w))


@pytest.mark.parametrize("kind", sorted(PARAMS))
def test_structure_is_the_ports(kind):
    n, src, dst, w = _edges(kind, PARAMS[kind], 3)
    ours = from_edges(n, src, dst, w).edge_list()
    port = (grid_road_graph(PARAMS[kind]["side"], seed=3)
            if kind == "grid_road"
            else power_law_digraph(PARAMS[kind]["n"], 4, seed=3,
                                   weighted=True)).edge_list()
    np.testing.assert_array_equal(ours[0], port[0])
    np.testing.assert_array_equal(ours[1], port[1])


def test_road_is_undirected():
    """Every road arc has its reverse, of the same weight."""
    n, src, dst, w = _edges("grid_road", PARAMS["grid_road"], 2 ** 31 + 9)
    fwd = dict(zip(zip(src.tolist(), dst.tolist()), w.tolist()))
    assert len(fwd) == src.shape[0]
    assert all(fwd[(v, u)] == x for (u, v), x in fwd.items())
