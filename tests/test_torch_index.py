"""The port's builder and index layout against the JAX package's.

The port keeps its own copies of the numpy builder and packer; on the
same graph and seed they must give the same index, array for array and
bit for bit — the three SweepPlans and the core closure (computed here
by plain torch) included.  An index file written by either package
loads in the other.
"""
import dataclasses
import warnings

import numpy as np
import pytest

import repro.core as J
import repro_torch.core as T
from repro.core.build_fast import build_hod_fast as jax_build_hod_fast
from repro_torch.core.index import floyd_warshall_closure

GRAPHS = {
    "grid12": lambda m: m.grid_road_graph(12, seed=1),
    "gnm200": lambda m: m.gnm_random_digraph(200, 800, seed=3),
    "powerlaw300": lambda m: m.power_law_digraph(300, 3, seed=2,
                                                 weighted=True),
}


def assert_index_equal(a, b) -> None:
    """Every field of two HoDIndex objects equal, plans included."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        elif dataclasses.is_dataclass(x):
            for g in dataclasses.fields(x):
                xa, ya = getattr(x, g.name), getattr(y, g.name)
                assert xa.dtype == ya.dtype, (f.name, g.name)
                np.testing.assert_array_equal(xa, ya,
                                              err_msg=f"{f.name}.{g.name}")
        else:
            assert x == y, (f.name, x, y)


def build_both(name, chunk=64, closure_limit=2048, core=(32, 1024)):
    gj, gt = GRAPHS[name](J), GRAPHS[name](T)
    rj = jax_build_hod_fast(gj, J.BuildConfig(max_core_nodes=core[0],
                                              max_core_edges=core[1]))
    rt = T.build_hod_fast(gt, T.BuildConfig(max_core_nodes=core[0],
                                            max_core_edges=core[1]))
    ixj = J.pack_index(gj, rj, chunk=chunk, closure_limit=closure_limit)
    ixt = T.pack_index(gt, rt, chunk=chunk, closure_limit=closure_limit,
                       device="cpu")
    return ixj, ixt


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_pack_index_matches_jax(name):
    ixj, ixt = build_both(name)
    assert ixt.n_core > 0 and ixt.core_closure.shape == (ixt.n_core,) * 2
    assert_index_equal(ixj, ixt)


def test_closure_skipped_above_limit_matches_jax():
    ixj, ixt = build_both("gnm200", closure_limit=8)
    assert ixt.core_closure.shape == (0, 0)
    assert_index_equal(ixj, ixt)


def test_closure_above_default_limit_matches_jax():
    """A core larger than the default closure_limit (2048), closed with
    the limit raised: the torch pivot loop equals the JAX closure."""
    gj, gt = J.grid_road_graph(84), T.grid_road_graph(84)
    cfg = dict(max_core_nodes=64, max_core_edges=1 << 12)
    rj = jax_build_hod_fast(gj, J.BuildConfig(**cfg))
    rt = T.build_hod_fast(gt, T.BuildConfig(**cfg))
    ixj = J.pack_index(gj, rj, chunk=512, closure_limit=4096)
    ixt = T.pack_index(gt, rt, chunk=512, closure_limit=4096, device="cpu")
    assert ixt.n_core > 2048
    assert_index_equal(ixj, ixt)


def test_floyd_warshall_matches_jax_on_random_core():
    rng = np.random.default_rng(5)
    c = 90
    adj = np.full((c, c), np.inf, np.float32)
    np.fill_diagonal(adj, 0.0)
    e = rng.integers(0, c, (400, 2))
    adj[e[:, 0], e[:, 1]] = np.minimum(
        adj[e[:, 0], e[:, 1]], rng.uniform(0.5, 9.5, 400).astype(np.float32))
    np.fill_diagonal(adj, 0.0)
    got, hops = floyd_warshall_closure(adj, device="cpu")
    want, want_hops = J.index.floyd_warshall_closure(adj)
    np.testing.assert_array_equal(got, want)
    assert hops == want_hops


@pytest.mark.parametrize("name", ["grid12", "powerlaw300"])
def test_jax_npz_loads_in_port(tmp_path, name):
    ixj, ixt = build_both(name)
    path = str(tmp_path / "hod.npz")
    ixj.save(path)
    assert_index_equal(ixj, T.HoDIndex.load(path))
    with np.load(path) as z:
        assert_index_equal(ixj, T.index_from_numpy(z))
        assert_index_equal(ixj, T.index_from_numpy(dict(z)))
    # and back: the port's file loads in the JAX package
    path2 = str(tmp_path / "hod_torch.npz")
    ixt.save(path2)
    assert_index_equal(ixt, J.HoDIndex.load(path2))


def test_v1_npz_without_plans_rebuilds_them(tmp_path):
    """Version-1 files carry no plans: the port rebuilds them (with a
    warning) and gets the plans the JAX package packed."""
    ixj, _ = build_both("gnm200")
    path = str(tmp_path / "v1.npz")
    ixj.save(path)
    with np.load(path) as z:
        keep = {k: z[k] for k in z.files
                if not k.startswith(("pf_", "pb_", "pc_"))
                and k != "format_version"}
    np.savez(path, **keep)
    with pytest.warns(UserWarning, match="without sweep plans"):
        ix = T.HoDIndex.load(path)
    assert ix.format_version == 1
    ix.format_version = ixj.format_version
    assert_index_equal(ixj, ix)


def test_scan_bytes_match_jax():
    ixj, ixt = build_both("grid12")
    for plan in ("plan_f", "plan_b", "plan_core"):
        for assoc in (False, True):
            assert getattr(ixt, plan).scan_bytes(assoc) == \
                getattr(ixj, plan).scan_bytes(assoc)
    for mode in ("closure", "bellman"):
        assert T.index.core_scan_bytes(ixt, mode) == \
            J.index.core_scan_bytes(ixj, mode)
    for fwd in (True, False):
        np.testing.assert_array_equal(T.index.plan_level_ids(ixt, fwd),
                                      J.index.plan_level_ids(ixj, fwd))
    ids = np.arange(ixt.n)
    np.testing.assert_array_equal(T.index.node_levels(ixt, ids),
                                  J.index.node_levels(ixj, ids))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert ixt.index_bytes() == ixj.index_bytes()
        assert ixt.plan_bytes() == ixj.plan_bytes()
