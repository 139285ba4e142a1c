"""The port's graph builders, neighbour sampler and GNN cell batches
against the JAX package's: the same numpy draws in the same order, so
every field is equal, bit for bit (``assert_array_equal`` on values and
dtypes)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.data import graphs as jg
from repro.data import sampler as js
from repro.launch import steps as jsteps
from repro_torch.data import graphs as tg
from repro_torch.data import sampler as ts
from repro_torch.launch import steps as tsteps
from repro_torch.models.gnn.common import GraphBatch

FIELDS = GraphBatch.TENSORS


def assert_same_batch(t, j):
    """Every field of the port's batch ``t`` equals the JAX batch ``j``'s."""
    assert (t.n_nodes, t.n_graphs) == (j.n_nodes, j.n_graphs)
    for k in FIELDS:
        a, b = getattr(t, k), getattr(j, k)
        if b is None:
            assert a is None, k
            continue
        b = np.asarray(b)
        got = a.cpu().numpy()
        assert got.dtype == b.dtype, (k, got.dtype, b.dtype)
        np.testing.assert_array_equal(got, b, err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(n_nodes=50, n_edges=300, d_feat=12),
    dict(n_nodes=50, n_edges=300, d_feat=12, with_geometry=False, seed=3),
    dict(n_nodes=40, n_edges=120, d_feat=0, feat_kind="int", n_graphs=5,
         n_classes=3, seed=7),
    dict(n_nodes=40, n_edges=120, d_feat=0, feat_kind="int",
         with_geometry=False, train_frac=0.5, seed=1),
])
def test_make_graph_batch_matches_jax(kw):
    assert_same_batch(tg.make_graph_batch(device="cpu", **kw),
                      jg.make_graph_batch(**kw))


def test_synth_feature_graph_matches_jax():
    assert_same_batch(tg.synth_feature_graph("full_graph_sm", seed=2,
                                             device="cpu"),
                      jg.synth_feature_graph("full_graph_sm", seed=2))


@pytest.mark.parametrize("kw", [dict(), dict(batch=5, n_nodes=9, n_edges=20,
                                             seed=4, n_classes=3)])
def test_synth_molecule_batch_matches_jax(kw):
    assert_same_batch(tg.synth_molecule_batch(device="cpu", **kw),
                      jg.synth_molecule_batch(**kw))


@pytest.mark.parametrize("geometry", [True, False])
@pytest.mark.parametrize("n_buckets", [1, 4, 7])
def test_bucket_edges_by_dst_matches_jax(geometry, n_buckets):
    kw = dict(n_nodes=70, n_edges=2000, d_feat=4, with_geometry=geometry,
              seed=n_buckets)
    t = tg.bucket_edges_by_dst(tg.make_graph_batch(device="cpu", **kw),
                               n_buckets, pad_factor=1.3)
    j = jg.bucket_edges_by_dst(jg.make_graph_batch(**kw), n_buckets,
                               pad_factor=1.3)
    assert_same_batch(t, j)
    # every real edge lies in its bucket's destination range
    cap = t.src.shape[0] // n_buckets
    rng_sz = -(-70 // n_buckets)
    dst = t.dst.numpy().reshape(n_buckets, cap)
    for b in range(n_buckets):
        real = dst[b][dst[b] < 70]
        assert ((real // rng_sz).clip(max=n_buckets - 1) == b).all()


def test_bucket_imbalance_raises_in_both():
    kw = dict(n_nodes=64, n_edges=400, d_feat=2, with_geometry=False)
    t = tg.make_graph_batch(device="cpu", **kw)
    j = jg.make_graph_batch(**kw)
    skew = np.zeros(400, np.int32)             # every edge into node 0
    t = dataclasses.replace(t, dst=torch.from_numpy(skew))
    j = dataclasses.replace(j, dst=skew)
    for fn, g in ((tg.bucket_edges_by_dst, t), (jg.bucket_edges_by_dst, j)):
        with pytest.raises(ValueError, match="bucket imbalance"):
            fn(g, 4)


def test_csr_from_edges_matches_jax():
    rng = np.random.default_rng(5)
    n, m = 300, 4000
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n // 2, m).astype(np.int32)   # nodes without in-edges
    for got, want in zip(ts.csr_from_edges(n, src, dst),
                         js.csr_from_edges(n, src, dst)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_neighbor_sampler_matches_jax():
    """The twin of test_checkpoint_ft.py's block-validity test: the same
    block as the JAX sampler's at two steps, each real edge between real
    nodes, the loss mask on the batch nodes, a pure function of (seed,
    step)."""
    rng = np.random.default_rng(0)
    n, m = 500, 3000
    src = rng.integers(0, n, m).astype(np.int64)
    dst = rng.integers(0, n, m).astype(np.int64)
    ptr, nbr = ts.csr_from_edges(n, src, dst)
    feats = rng.normal(size=(n, 8)).astype(np.float32)
    labels = rng.integers(0, 5, n).astype(np.int32)
    tsam = ts.NeighborSampler(ptr, nbr, feats, labels, fanout=(3, 2),
                              device="cpu")
    jsam = js.NeighborSampler(ptr, nbr, feats, labels, fanout=(3, 2))
    batch_ids = rng.choice(n, 16, replace=False)
    max_n, max_e = tsam.block_shape(16)
    assert (max_n, max_e) == jsam.block_shape(16) == (16 + 48 + 96, 48 + 96)
    for step in (0, 5):
        block = tsam.sample(batch_ids, step=step)
        assert_same_batch(block, jsam.sample(batch_ids, step=step))
        assert block.node_feat.shape == (max_n, 8)
        assert int(block.train_mask.sum()) == 16
        s, d = block.src.numpy(), block.dst.numpy()
        real = s < max_n
        assert real.sum() > 16 and (d[real] < max_n).all()
        assert (d[~real] == max_n).all()                  # sentinel pads
        assert_same_batch(tsam.sample(batch_ids, step=step), block)
    assert not torch.equal(tsam.sample(batch_ids, 0).src,
                           tsam.sample(batch_ids, 5).src)


CELLS = [(a, s) for a in ("gcn-cora", "gin-tu", "schnet", "equiformer-v2")
         for s in ("full_graph_sm", "minibatch_lg", "ogb_products",
                   "molecule")]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_concrete_batches_match_jax(arch, shape):
    """``_gnn_concrete_batch`` at the smoke scale of all 16 cells, and
    the smoke cells' configs."""
    sp = tsteps.SHAPE_PARAMS["gnn"][shape]
    assert sp == jsteps.SHAPE_PARAMS["gnn"][shape]
    t = tsteps._gnn_concrete_batch(arch, sp, device="cpu")
    assert_same_batch(t, jsteps._gnn_concrete_batch(arch, sp))
    tc = tsteps.build_cell(arch, shape, smoke=True, device="cpu")
    jc = jsteps.build_cell(arch, shape, smoke=True)
    tcfg, jcfg = dataclasses.asdict(tc.meta["cfg"]), dataclasses.asdict(
        jc.meta["cfg"])
    assert {k: v for k, v in tcfg.items() if k != "dtype"} == \
        {k: v for k, v in jcfg.items() if k != "dtype"}
    assert tc.model_flops == jc.model_flops
    assert_same_batch(tc.args[1], jc.args[1])
