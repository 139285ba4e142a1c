"""The port's GNN family against the JAX package's, on the same numpy
inputs, with the JAX parameters carried across by
``convert.gnn_params_from_numpy``.

Tolerances, each with its reason (f32 on both sides; the scatters and
matmuls sum in other orders):

* loss rtol 1e-5;
* every gradient leaf rtol 1e-4 with an atol of 1e-5 of the leaf's
  largest magnitude (an element that cancels keeps the absolute error of
  its summands' scale), as ``test_torch_train.py`` holds the LM;
* forward outputs rtol 1e-5 with an atol of 1e-5 of their largest
  magnitude;
* 3 train steps of each smoke cell: loss and the gradient norm rtol
  1e-5; AdamW's m and v rtol 1e-5 with an atol of 1e-5 of each leaf's
  largest magnitude; the update ``p - p0`` rtol 1e-4 with an atol of
  1e-4 of the leaf's largest update (an element whose gradient cancels to
  near AdamW's eps has a step set by f32 noise, up to ``lr`` a step);
* equivariance: outputs invariant under a rotation of the edge vectors
  within atol 1e-4, rotations orthogonal within 1e-5 (the JAX test's
  bounds, ``tests/test_models.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import graphs as jgraphs
from repro.data import sampler as jsampler
from repro.launch import steps as jsteps
from repro.models.gnn.common import GraphBatch as JBatch
from repro_torch.data import graphs as tgraphs
from repro_torch.launch import steps as tsteps
from repro_torch.models.convert import (adamw_state_from_numpy,
                                        gnn_params_from_numpy)
from repro_torch.models.gnn import common as tcommon
from repro_torch.models.gnn import equiformer_v2 as teq
from repro_torch.models.gnn.common import GraphBatch
from repro_torch.tree import flatten_with_paths, leaves

KEY = jax.random.PRNGKey(0)
ARCHS = ("gcn-cora", "gin-tu", "schnet", "equiformer-v2")
SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")


def _np(a):
    return np.asarray(a)


def to_torch(g: JBatch) -> GraphBatch:
    return GraphBatch(g.n_nodes, g.n_graphs, **{
        k: None if getattr(g, k) is None
        else torch.from_numpy(np.array(getattr(g, k)))
        for k in GraphBatch.TENSORS})


def torch_cfg(arch, jcfg):
    """The port's config class of ``arch`` with ``jcfg``'s fields (f32)."""
    cls = type(tsteps.get_arch(arch).CONFIG)
    return cls(**{k: v for k, v in dataclasses.asdict(jcfg).items()
                  if k != "dtype"})


@functools.lru_cache(maxsize=None)
def smoke_pair(arch, shape):
    """(JAX smoke cell's config, its params, its batch)."""
    jc = jsteps.build_cell(arch, shape, smoke=True)
    return jc.meta["cfg"], jc.args[0]["params"], jc.args[1]


def assert_close(got: torch.Tensor, want, rtol, scale_tol, what=""):
    want = _np(want).astype(np.float32)
    got = got.detach().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=scale_tol * np.abs(want).max(),
                               err_msg=what)


def check_against_jax(arch, jcfg, jp, jb, tb=None):
    """Forward (or predict), loss and every gradient leaf of the port at
    ``jcfg`` on ``jb`` against JAX's."""
    jmod, tmod = jsteps.GNN_MODULES[arch], tsteps.GNN_MODULES[arch]
    tcfg = torch_cfg(arch, jcfg)
    tp = gnn_params_from_numpy(jax.tree.map(np.asarray, jp), arch, tcfg,
                               device="cpu")
    tb = to_torch(jb) if tb is None else tb
    out = getattr(jmod, "predict", jmod.forward)

    def jax_side(p, g):                      # one compile a case
        return out(p, g, jcfg), jax.value_and_grad(
            lambda q: jmod.loss_fn(q, g, jcfg))(p)
    jout, (jl, jg) = jax.jit(jax_side)(jp, jb)
    with torch.no_grad():
        tout = getattr(tmod, "predict", tmod.forward)(tp, tb, tcfg)
    assert torch.isfinite(tout).all()
    assert_close(tout, jout, 1e-5, 1e-5, "forward")
    tl, tg = tsteps.value_and_grad(lambda p: tmod.loss_fn(p, tb, tcfg), tp)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for (k, g), w in zip(flatten_with_paths(tg), jax.tree.leaves(jg)):
        assert_close(g, w, 1e-4, 1e-5, k)
    return tcfg, tp, tb


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_cells_match_jax(arch, shape):
    """Every architecture on every shape's smoke cell."""
    check_against_jax(arch, *smoke_pair(arch, shape))


@pytest.mark.parametrize("arch,repl", [
    ("gcn-cora", dict(edge_chunk=33)),
    ("gin-tu", dict(edge_chunk=33)),
    ("schnet", dict(edge_chunk=33)),
    ("equiformer-v2", dict(edge_chunk=33)),
    ("gcn-cora", dict(edge_layout="partitioned", edge_chunk=33)),
    ("gin-tu", dict(edge_layout="partitioned")),
    ("schnet", dict(edge_layout="partitioned", edge_chunk=33)),
])
def test_chunked_and_partitioned_match_jax(arch, repl):
    """Chunked scatters (256 edges in 8 chunks of 33, the last padded
    with sentinel edges) and the one-device partitioned aggregation."""
    jcfg, jp, jb = smoke_pair(arch, "full_graph_sm")
    check_against_jax(arch, dataclasses.replace(jcfg, **repl), jp, jb)


def test_equiformer_dst_ranged_matches_jax():
    """EquiformerV2's ``dst_ranged`` chunks over ``bucket_edges_by_dst``:
    4 buckets of 80 (64 of them sentinel pads), one chunk a bucket."""
    jcfg, jp, _ = smoke_pair("equiformer-v2", "full_graph_sm")
    kw = dict(n_nodes=64, n_edges=256, d_feat=jcfg.d_in, n_classes=7)
    jb = jgraphs.bucket_edges_by_dst(jgraphs.make_graph_batch(**kw), 4,
                                     pad_factor=1.25)
    tb = tgraphs.bucket_edges_by_dst(
        tgraphs.make_graph_batch(device="cpu", **kw), 4, pad_factor=1.25)
    assert tb.src.shape == (320,)
    cfg = dataclasses.replace(jcfg, edge_layout="dst_ranged", edge_chunk=80)
    tcfg, tp, _ = check_against_jax("equiformer-v2", cfg, jp, jb, tb)
    # the layout changes only the order of the sums
    with torch.no_grad():
        a = teq.predict(tp, tb, tcfg)
        b = teq.predict(tp, tb, dataclasses.replace(
            tcfg, edge_layout="arbitrary", edge_chunk=0))
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_sampled_block_matches_jax(arch):
    """A NeighborSampler block (sentinel-padded edges, loss on the batch
    nodes) through each architecture, node level."""
    rng = np.random.default_rng(1)
    n, m, f = 200, 1500, 12
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    ptr, nbr = jsampler.csr_from_edges(n, src, dst)
    sam = jsampler.NeighborSampler(
        ptr, nbr, rng.normal(size=(n, f)).astype(np.float32),
        rng.integers(0, 5, n).astype(np.int32), fanout=(4, 3))
    jb = sam.sample(rng.choice(n, 8, replace=False), step=2)
    assert int(np.sum(_np(jb.src) == jb.n_nodes)) > 0    # sentinel edges
    jcfg, jp, _ = smoke_pair(arch, "minibatch_lg")
    jcfg = dataclasses.replace(jcfg, d_in=f, **(
        {"n_classes": 5} if arch in ("gcn-cora", "gin-tu")
        else {"n_targets": 5}))
    jmod = jsteps.GNN_MODULES[arch]
    check_against_jax(arch, jcfg, jmod.init_params(KEY, jcfg), jb)


def test_equivariance_and_rotations():
    """The twin of ``tests/test_models.py::test_gnn_equivariance_and_
    chunking`` on the port: the invariant output does not change when
    every edge vector is rotated, and each l's rotations are
    orthogonal."""
    rng = np.random.default_rng(0)
    n, e = 30, 100
    src = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    vec = rng.normal(size=(e, 3)).astype(np.float32)
    cfg = teq.EquiformerV2Config(n_layers=2, d_hidden=32, l_max=4, m_max=2,
                                 n_heads=4, n_rbf=16)
    p = teq.init_params(cfg, device="cpu")
    feat = torch.from_numpy(rng.integers(0, 10, n).astype(np.int32))

    def out_for(v):
        g = GraphBatch(n_nodes=n, n_graphs=1, src=src, dst=dst,
                       node_feat=feat, edge_feat=torch.from_numpy(v),
                       graph_ids=torch.zeros(n, dtype=torch.int32))
        with torch.no_grad():
            return teq.predict(p, g, cfg)

    th1, th2 = 0.73, 0.41
    rz = np.array([[np.cos(th1), -np.sin(th1), 0],
                   [np.sin(th1), np.cos(th1), 0], [0, 0, 1]], np.float32)
    ry = np.array([[np.cos(th2), 0, np.sin(th2)], [0, 1, 0],
                   [-np.sin(th2), 0, np.cos(th2)]], np.float32)
    np.testing.assert_allclose(out_for(vec).numpy(),
                               out_for(vec @ (rz @ ry).T).numpy(), atol=1e-4)
    rots = teq._edge_rotations(torch.from_numpy(vec), 4)
    for l, r in enumerate(rots):
        eye = torch.einsum("eij,ekj->eik", r, r)
        assert (eye - torch.eye(2 * l + 1)).abs().max().item() < 1e-5


def test_constants_are_the_jax_modules():
    """The Wigner constants (numpy, verbatim) and the rbf centers (XLA's
    folded ``jnp.linspace``) equal the JAX package's, bit for bit."""
    from repro.models.gnn import equiformer_v2 as jeq
    from repro_torch.models.gnn.schnet import rbf_centers
    for got, want in zip(teq._rotation_constants(6),
                         jeq._rotation_constants(6)):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for n_rbf, cutoff in ((300, 10.0), (64, 10.0), (16, 10.0), (7, 3.3)):
        got = rbf_centers(n_rbf, cutoff, torch.device("cpu")).numpy()
        np.testing.assert_array_equal(got, np.asarray(jnp.linspace(
            0.0, cutoff, n_rbf, dtype=jnp.float32)))


def test_sentinels_read_fill_and_write_scrap():
    """A sentinel index reads the fill value and its scatter lands in the
    scrap row: no real node is read or written (clamping would do both)."""
    x = torch.arange(6, dtype=torch.float32).reshape(3, 2) + 1
    idx = torch.tensor([2, 3, 0], dtype=torch.int32)
    assert tcommon.take(x, idx).tolist() == [[5, 6], [0, 0], [1, 2]]
    assert tcommon.take(x, idx, fill=1.0)[1].tolist() == [1, 1]
    s = tcommon.scatter_sum(torch.ones(3, 2), idx, 3)
    assert s.tolist() == [[1, 1], [0, 0], [1, 1]]
    m = tcommon.scatter_max(torch.tensor([4.0, 9.0, -2.0]), idx, 3)
    assert m.tolist() == [-2.0, -float("inf"), 4.0]


def test_segment_primitives_match_jax():
    """``segment_softmax``, ``scatter_max``, ``degrees`` and the mean
    ``graph_readout`` against the JAX package's, with sentinel indices
    (id n) and empty segments."""
    from repro.models.gnn import common as jc
    rng = np.random.default_rng(3)
    n, e = 12, 60
    idx = rng.integers(0, n + 1, e).astype(np.int32)   # n: the sentinel
    idx[idx == 5] = 6                                   # segment 5 empty
    vals = rng.normal(size=(e, 3)).astype(np.float32) * 4
    ti, tv = torch.from_numpy(idx), torch.from_numpy(vals)
    ji, jv = jnp.asarray(idx), jnp.asarray(vals)
    assert_close(tcommon.segment_softmax(tv, ti, n),
                 jc.segment_softmax(jv, ji, n), 1e-6, 1e-7, "softmax")
    np.testing.assert_array_equal(tcommon.scatter_max(tv, ti, n).numpy(),
                                  _np(jc.scatter_max(jv, ji, n)))
    np.testing.assert_array_equal(tcommon.degrees(ti, n).numpy(),
                                  _np(jc.degrees(ji, n)))
    assert_close(tcommon.graph_readout(tv, ti, n, op="mean"),
                 jc.graph_readout(jv, ji, n, op="mean"), 1e-6, 1e-7,
                 "readout")


# --------------------------------------------------------------------------
# 3 train steps of each smoke cell against the JAX cell
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", [
    ("gcn-cora", "full_graph_sm"), ("gin-tu", "full_graph_sm"),
    ("schnet", "molecule"), ("equiformer-v2", "molecule")])
def test_three_train_steps_match_the_jax_cell(arch, shape):
    jc = jsteps.build_cell(arch, shape, smoke=True)
    tc = tsteps.build_cell(arch, shape, smoke=True, device="cpu")
    jb, tb = jc.args[1], tc.args[1]
    jfn = jax.jit(jc.fn)
    jstate = jc.args[0]
    p0 = [_np(w) for w in jax.tree.leaves(jstate["params"])]
    tcfg = tc.meta["cfg"]
    params = gnn_params_from_numpy(
        jax.tree.map(np.asarray, jstate["params"]), arch, tcfg, device="cpu")
    tstate = {"params": params, "opt": adamw_state_from_numpy(
        jax.tree.map(np.asarray, jstate["opt"]), params, device="cpu")}
    for step in range(3):
        jstate, jm = jfn(jstate, jb)
        out, tm = tc.fn(tstate, *tc.batch_at(step))
        assert out is tstate                           # in place
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(tm["gnorm"].item(), float(jm["gnorm"]),
                                   rtol=1e-5)
    assert int(tstate["opt"].count) == int(jstate["opt"].count) == 3
    for name in ("m", "v"):
        for (k, g), w in zip(flatten_with_paths(getattr(tstate["opt"], name)),
                             jax.tree.leaves(getattr(jstate["opt"], name))):
            assert_close(g, w, 1e-5, 1e-5, f"{name} {k}")
    moved = 0
    for (k, p), w, w0 in zip(flatten_with_paths(tstate["params"]),
                             jax.tree.leaves(jstate["params"]), p0):
        want = _np(w) - w0
        moved += bool(np.abs(want).max() > 0)
        assert_close(p - torch.tensor(w0), want, 1e-4, 1e-4, k)
    assert moved > len(p0) // 2
    assert tb is tc.batch_at(7)[0]                     # one graph a step
    for k in GraphBatch.TENSORS:
        if getattr(jb, k) is not None:
            np.testing.assert_array_equal(getattr(tb, k).numpy(),
                                          _np(getattr(jb, k)))


# --------------------------------------------------------------------------
# the cells and entry points of the port
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_every_smoke_cell_steps_on_the_cpu(arch, shape):
    """All 16 GNN smoke cells build and take two steps in place: finite
    losses, the count stepping on, the parameters moving."""
    cell = tsteps.build_cell(arch, shape, smoke=True, device="cpu")
    assert cell.kind == "train" and cell.family == "gnn"
    assert cell.model_flops > 0
    state = cell.args[0]
    before = [p.clone() for p in leaves(state["params"])]
    for step in range(2):
        out, metrics = cell.fn(state, *cell.batch_at(step))
        assert out is state and torch.isfinite(metrics["loss"])
        assert int(state["opt"].count) == step + 1
    moved = sum(not torch.equal(a, b)
                for a, b in zip(before, leaves(state["params"])))
    assert moved > len(before) // 2


def test_train_cli_trains_a_gnn(tmp_path, capsys):
    """The train CLI takes the GNN archs (``train_4k`` means
    ``full_graph_sm``, as in the JAX package's ``launch/train.py``) and
    resumes from its checkpoints."""
    from repro_torch.launch import train
    args = ["--arch", "gin-tu", "--smoke", "--device", "cpu",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    first = train.main(args + ["--steps", "2"])
    second = train.main(args + ["--steps", "3"])
    assert "resumed from step 1" in capsys.readouterr().out
    assert first["step"] == 1 and second["step"] == 2
    assert np.isfinite(second["loss"])


def test_gnn_entry_points_default_to_the_card(tmp_path):
    """Without ``device="cpu"`` the GNN builders, models, converter and
    cells run on the card, and raise where there is none."""
    from repro_torch.data import sampler as tsam
    from repro_torch.launch import train
    from repro_torch.models.gnn import gcn
    cfg = tsteps.get_arch("gcn-cora").smoke_config()
    ptr = np.array([0, 1, 2]), np.array([1, 0])
    calls = [lambda: tgraphs.make_graph_batch(8, 16, 4),
             lambda: tgraphs.synth_molecule_batch(batch=2),
             lambda: tsam.NeighborSampler(*ptr, np.zeros((2, 3), np.float32),
                                          np.zeros(2, np.int32)).sample(
                 np.array([0])),
             lambda: gcn.init_params(cfg),
             lambda: gnn_params_from_numpy(
                 jax.tree.map(np.asarray, smoke_pair(
                     "gcn-cora", "full_graph_sm")[1]), "gcn-cora",
                 torch_cfg("gcn-cora", smoke_pair(
                     "gcn-cora", "full_graph_sm")[0])),
             lambda: tsteps.build_cell("schnet", "molecule", smoke=True),
             lambda: train.main(["--arch", "gcn-cora", "--smoke", "--steps",
                                 "1", "--ckpt-dir", str(tmp_path)])]
    if torch.cuda.is_available():
        assert calls[0]().src.device.type == "cuda"
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_cells_refuse_what_they_do_not_have():
    with pytest.raises(ValueError, match="LM or DLRM batch"):
        tsteps.build_cell("gcn-cora", "molecule", smoke=True, device="cpu",
                          batch=2)
    with pytest.raises(NotImplementedError, match="'opt' variant"):
        tsteps.build_cell("dlrm-rm2", "serve_p99", smoke=True, device="cpu",
                          variant="opt")
    with pytest.raises(KeyError, match="unknown arch"):
        tsteps.build_cell("qwen3-moe-30b-a3b", "train_4k", device="cpu")


def test_opt_layout_buckets_equiformer_chunks():
    """``variant="opt"``: EquiformerV2's ``dst_ranged`` chunks need its
    edges bucketed by destination, one bucket a chunk; the bucketed graph
    gives the same prediction as the arbitrary order."""
    jcfg, jp, _ = smoke_pair("equiformer-v2", "full_graph_sm")
    tcfg = dataclasses.replace(torch_cfg("equiformer-v2", jcfg),
                               edge_chunk=100)
    tp = gnn_params_from_numpy(jax.tree.map(np.asarray, jp), "equiformer-v2",
                               tcfg, device="cpu")
    g = tgraphs.make_graph_batch(64, 256, tcfg.d_in, device="cpu")
    b = tsteps._dst_ranged(g, tcfg.edge_chunk)
    assert b.src.shape[0] == 3 * 99                     # ceil(256 * 1.15 / 100)
    ranged = dataclasses.replace(tcfg, edge_layout="dst_ranged")
    with torch.no_grad():
        torch.testing.assert_close(teq.predict(tp, b, ranged),
                                   teq.predict(tp, g, tcfg),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("edge_chunk", [0, 700])
def test_forward_saves_no_messages(edge_chunk):
    """What GCN's forward leaves saved for backward holds none of its
    [E, F] (or [e_c, F]) messages: its scatters keep only their indices
    (and the chunked one rematerialises each chunk), as JAX's transposed
    scatter does."""
    from repro_torch.models.gnn import gcn
    g = tgraphs.make_graph_batch(400, 6000, 10, n_classes=9, device="cpu")
    cfg = gcn.GCNConfig(d_in=10, d_hidden=16, n_classes=9,
                        edge_chunk=edge_chunk)
    p = {"layers": [[t.requires_grad_(True) for t in wb] for wb in
                    gcn.init_params(cfg, device="cpu")["layers"]]}
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        gcn.loss_fn(p, g, cfg)
    edge_rows = {6000, -(-6000 // 9)}                  # all, one chunk of 9
    assert saved and not [s for s in saved
                          if len(s) == 2 and s[0] in edge_rows and s[1] > 1]
