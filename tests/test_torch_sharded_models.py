"""The port's sharded model branches against its unmapped functions and
the JAX package's.

One gloo group a world size (1 to 4) runs every case
(``torchdist_bodies.models_battery``) on each rank's blocks under the
``(1, world)`` smoke mesh and its family's rules: split-KV
``attention_decode`` (full cache, and a rolling window cache), the
expert-parallel ``moe_block`` at capacity factors 1.25 and 0.5,
row-sharded ``embedding_lookup`` and ``retrieval_scores``, and
``partitioned_aggregate`` (a GCN edge function, 1 and 3 chunks).

Bounds.  ``attention_decode`` and ``moe_block`` sum across ranks in
another order than one device: atol 1e-5 in f32 (the bounds of
``tests/test_distribution.py``), against the port's unmapped function
and JAX's; at world size 1 the expert-parallel MoE is the unmapped one
bit for bit, and both match JAX's mapped branch (run as
``tests/test_distribution.py`` runs it) within the same bound.  The
split-KV body is plain torch, the unmapped decode ``flash_decode``'s
plain version: another algorithm, so atol 1e-5 there too.  The lookup,
the retrieval and the aggregate add only exact zeros across ranks: bit
for bit against the port's unmapped functions; against JAX the lookup
is exact, the retrieval's scores rtol 1e-5 / atol 1e-6 and the
aggregate rtol 1e-5 / atol 1e-5 (its matvec and scatter-add sum in
another order, as ``tests/test_torch_dlrm.py`` and
``tests/test_torch_gnn.py`` hold them).  The dlrm-rm2 smoke serve cell
under ``rules_recsys`` at 2 and 4 ranks gives the unsharded cell's
logits bit for bit, and the smoke cells' sharding trees align with
their arguments leaf for leaf (every cell runs on the 2-rank mesh).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.shardlib as jsl
from repro.launch.mesh import (make_smoke_mesh, rules_gnn, rules_recsys,
                               rules_serve_lm, rules_train_lm)
from repro.models import dlrm as jdlrm
from repro.models.gnn.common import partitioned_aggregate as j_aggregate
from repro.models.layers import MoEConfig as JMoE
from repro.models.layers import attention_decode as j_decode
from repro.models.layers import moe_block as j_moe
from repro_torch.launch import steps
import torchdist
import torchdist_bodies as bodies

N_NODES = 24


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with torchdist.one_thread():
        yield


def _buckets(src, dst, coef, world):
    """Edges reordered so rank r holds exactly those whose destination
    is in its node slice, each bucket padded to one size with sentinel
    edges (``bucket_edges_by_dst``'s layout)."""
    per = N_NODES // world
    b = dst // per
    cap = int(np.bincount(b, minlength=world).max())
    out = [np.full(cap * world, N_NODES, np.int32),
           np.full(cap * world, N_NODES, np.int32),
           np.zeros(cap * world, np.float32)]
    for r in range(world):
        sel = np.flatnonzero(b == r)
        for o, a in zip(out, (src, dst, coef)):
            o[r * cap:r * cap + sel.size] = a[sel]
    return out


def _payload(world):
    rng = np.random.default_rng(0)
    f32 = np.float32
    b, h, kh, dh, s, w = 2, 4, 2, 16, 48, 12
    p = {"q": rng.normal(size=(b, h, dh)).astype(f32),
         "kn": rng.normal(size=(b, kh, dh)).astype(f32),
         "vn": rng.normal(size=(b, kh, dh)).astype(f32),
         "kc_full": rng.normal(size=(b, s, kh, dh)).astype(f32),
         "vc_full": rng.normal(size=(b, s, kh, dh)).astype(f32),
         "kc_rolling": rng.normal(size=(b, w, kh, dh)).astype(f32),
         "vc_rolling": rng.normal(size=(b, w, kh, dh)).astype(f32),
         "window": w, "curs_full": [5, 30, 47], "curs_roll": [5, 30, 47]}
    e, d, ff = 12, 32, 16
    p.update(x=rng.normal(size=(2, 8, d)).astype(f32),
             router=rng.normal(size=(d, e)).astype(f32),
             wg=(rng.normal(size=(e, d, ff)) * 0.1).astype(f32),
             wu=(rng.normal(size=(e, d, ff)) * 0.1).astype(f32),
             wd=(rng.normal(size=(e, ff, d)) * 0.1).astype(f32))
    ids = rng.integers(0, 48, (6, 4)).astype(np.int32)
    ids[0, 1], ids[3, 2] = -1, 48                 # outside: zero rows
    cand = rng.integers(0, 48, 96).astype(np.int32)
    cand[[7, 50]] = 50
    p.update(tables=rng.normal(size=(4, 48, 8)).astype(f32), ids=ids,
             dense=rng.normal(size=(6, 5)).astype(f32), cand=cand,
             bot_mlp=(5, 16, 8), n_bot=2,
             bw0=(rng.normal(size=(5, 16)) * 0.4).astype(f32),
             bb0=(rng.normal(size=16) * 0.1).astype(f32),
             bw1=(rng.normal(size=(16, 8)) * 0.25).astype(f32),
             bb1=(rng.normal(size=8) * 0.1).astype(f32))
    src = rng.integers(0, N_NODES, 60).astype(np.int32)
    dst = rng.integers(0, N_NODES, 60).astype(np.int32)
    coef = rng.random(60).astype(f32)
    p["src"], p["dst"], p["coef"] = _buckets(src, dst, coef, world)
    p.update(feat=rng.normal(size=(N_NODES, 8)).astype(f32),
             n_nodes=N_NODES)
    return p


def _jax_decode(p, name, window, curs, rules=None):
    """JAX's decode over ``curs`` in turn (unmapped, or its mapped
    branch under the smoke mesh and ``rules``)."""
    j = {k: jnp.asarray(v) for k, v in p.items()
         if isinstance(v, np.ndarray)}
    kc, vc = j[f"kc_{name}"], j[f"vc_{name}"]
    # one trace per call site: a jitted function traced outside the rules
    # would be reused inside them
    step = jax.jit(lambda *a: j_decode(*a, window=window))
    out = {}
    for cur in curs:
        args = (j["q"], kc, vc, j["kn"], j["vn"], jnp.int32(cur))
        if rules is None:
            o, kc, vc = step(*args)
        else:
            mesh = make_smoke_mesh()
            with jsl.axis_rules(mesh, rules(mesh)):
                o, kc, vc = step(*args)
        out[cur] = np.asarray(o)
    out["k"], out["v"] = np.asarray(kc), np.asarray(vc)
    return out


def _jax_moe(p, cf, mapped):
    e, _, ff = p["wg"].shape
    cfg = JMoE(n_experts=e, top_k=2, d_ff=ff, capacity_factor=cf)
    a = [jnp.asarray(p[k]) for k in ("x", "router", "wg", "wu", "wd")]
    if not mapped:
        y, aux = jax.jit(lambda *a: j_moe(*a, cfg))(*a)
    else:
        mesh = make_smoke_mesh()
        r = rules_train_lm(mesh)
        r.update(rules_gnn(mesh))
        r.update({"rows": "model", "cand": ("data",)})
        with jsl.axis_rules(mesh, r):
            y, aux = jax.jit(lambda *a: j_moe(*a, cfg))(*a)
    return np.asarray(y), float(aux)


@pytest.fixture(scope="module")
def jax_results():
    """JAX's unmapped answers, and its mapped decode, MoE and lookup
    (world size 1), on the inputs every world size shares."""
    p = _payload(1)
    out = {}
    for name, window, curs in (("full", None, p["curs_full"]),
                               ("rolling", p["window"], p["curs_roll"])):
        out["decode", name] = _jax_decode(p, name, window, curs)
        out["decode_mapped", name] = _jax_decode(
            p, name, window, curs,
            rules=lambda m: rules_serve_lm(m, p["q"].shape[0]))
    for cf in (1.25, 0.5):
        out["moe", cf] = _jax_moe(p, cf, mapped=False)
        out["moe_mapped", cf] = _jax_moe(p, cf, mapped=True)
    tables, ids = jnp.asarray(p["tables"]), jnp.asarray(p["ids"])
    out["lookup"] = np.asarray(jdlrm.embedding_lookup(tables, ids))
    mesh = make_smoke_mesh()
    with jsl.axis_rules(mesh, rules_recsys(mesh, ids.shape[0])):
        out["lookup_mapped"] = np.asarray(
            jax.jit(jdlrm.embedding_lookup)(tables, ids))
    params = {"tables": tables,
              "bot": [[jnp.asarray(p[f"bw{i}"]), jnp.asarray(p[f"bb{i}"])]
                      for i in range(p["n_bot"])]}
    cfg = jdlrm.DLRMConfig(n_dense=5, n_sparse=4, embed_dim=8,
                           vocab_per_table=48, bot_mlp=p["bot_mlp"],
                           top_mlp=(1,))
    for top_k in (8, 1000):
        v, i = jdlrm.retrieval_scores(
            params, jnp.asarray(p["dense"]), ids[:1],
            jnp.asarray(p["cand"]), cfg, top_k=top_k)
        out["retrieval", top_k] = (np.asarray(v), np.asarray(i))
    return out


def _jax_aggregate(p):
    """JAX's unmapped aggregate on a world size's bucketed edges (jitted:
    a third of the eager dispatch's time, the same values)."""
    arrays = tuple(jnp.asarray(p[k]) for k in ("src", "dst", "coef"))
    x = jnp.asarray(p["feat"])

    def edge_fn(xf, s, d, c):
        return jnp.take(xf, s, axis=0, fill_value=0) * c[:, None], d

    def agg(x, arrays, chunks):
        return j_aggregate(x, arrays, edge_fn, N_NODES, x.shape[1:],
                           x.dtype, n_chunks=chunks)
    return {chunks: np.asarray(jax.jit(agg, static_argnums=2)(
        x, arrays, chunks)) for chunks in (1, 3)}


@pytest.fixture(scope="module")
def rm2_unsharded():
    cell = steps.build_cell("dlrm-rm2", "serve_p99", smoke=True,
                            device="cpu")
    return cell.run().numpy()


@pytest.fixture(scope="module")
def spawned():
    """One spawn of 4 ranks: gloo groups of 4, 3 and 2 ranks (the first
    w; ``torchdist_bodies.worlds``), each on its world's payload; started
    before JAX's references are computed, collected by the first case of
    a world above 1."""
    ranks = torchdist.Ranks(
        4, "torchdist_bodies:models_battery",
        {"by_world": {w: _payload(w) for w in (2, 3, 4)}}, timeout=180.0)
    yield ranks
    ranks.close()


@pytest.fixture(scope="module", params=[1, 2, 3, 4])
def world(request, spawned, jax_results):
    w = request.param
    p = _payload(w)
    if w == 1:
        outs = [torchdist.run_ranks(1, "torchdist_bodies:models_battery",
                                    {"by_world": {1: p}})[0][1]]
    else:
        outs = [spawned.results()[r][w] for r in range(w)]
    want = dict(jax_results)
    want.update((("aggregate", c), a) for c, a in _jax_aggregate(p).items())
    return w, outs, bodies.models_cases(p), want


@pytest.mark.parametrize("name", ["full", "rolling"])
def test_split_kv_decode(world, name):
    w, outs, ref, want = world
    curs = [k[2] for k in ref if k[:2] == ("decode", name)
            and isinstance(k[2], int)]
    assert curs
    for out in outs:
        for key in curs + ["k", "v"]:
            got = out["decode", name, key]
            np.testing.assert_allclose(got, ref["decode", name, key],
                                       atol=1e-5, rtol=0)
            np.testing.assert_allclose(got, want["decode", name][key],
                                       atol=1e-5, rtol=0)
            if w == 1:
                np.testing.assert_allclose(
                    got, want["decode_mapped", name][key], atol=1e-5,
                    rtol=0)
        for key in ("k", "v"):        # the write is a copy: exact
            np.testing.assert_array_equal(out["decode", name, key],
                                          ref["decode", name, key])


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_expert_parallel_moe(world, cf):
    w, outs, ref, want = world
    for out in outs:
        y, aux = out["moe", cf]
        if w == 1:
            np.testing.assert_array_equal(y, ref["moe", cf][0])
            assert aux == ref["moe", cf][1]
            np.testing.assert_allclose(y, want["moe_mapped", cf][0],
                                       atol=1e-5, rtol=0)
        np.testing.assert_allclose(y, ref["moe", cf][0], atol=1e-5, rtol=0)
        np.testing.assert_allclose(y, want["moe", cf][0], atol=1e-5, rtol=0)
        np.testing.assert_allclose(aux, want["moe", cf][1], rtol=1e-5)


def test_row_sharded_lookup(world):
    w, outs, ref, want = world
    for out in outs:
        np.testing.assert_array_equal(out["lookup"], ref["lookup"])
        np.testing.assert_array_equal(out["lookup"], want["lookup"])
        if w == 1:
            np.testing.assert_array_equal(out["lookup"],
                                          want["lookup_mapped"])


@pytest.mark.parametrize("top_k", [8, 1000])
def test_row_sharded_retrieval(world, top_k):
    w, outs, ref, want = world
    for out in outs:
        vals, ids = out["retrieval", top_k]
        np.testing.assert_array_equal(vals, ref["retrieval", top_k][0])
        np.testing.assert_array_equal(ids, ref["retrieval", top_k][1])
        jv, ji = want["retrieval", top_k]
        np.testing.assert_array_equal(ids, ji)
        np.testing.assert_allclose(vals, jv, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("chunks", [1, 3])
def test_partitioned_aggregate(world, chunks):
    w, outs, ref, want = world
    for out in outs:
        got = out["aggregate", chunks]
        np.testing.assert_array_equal(got, ref["aggregate", chunks])
        np.testing.assert_allclose(got, want["aggregate", chunks],
                                   rtol=1e-5, atol=1e-5)


def test_rm2_serve_cell_under_rules_recsys(world, rm2_unsharded):
    """dlrm-rm2's smoke serve cell with each rank's table block: the
    unsharded cell's logits (at 2 and 4 ranks, which split its 1,000
    rows; 3 does not)."""
    w, outs, ref, want = world
    for out in outs:
        assert ("rm2_serve" in out) == (w in (2, 4))
        if w in (2, 4):
            np.testing.assert_array_equal(out["rm2_serve"], rm2_unsharded)


def test_cells_have_consistent_sharding_trees(world):
    """The JAX test of the same name on smoke cells (the port's full
    cells allocate the full size), on the 2-rank mesh: as many sharding
    leaves as argument leaves (a graph batch's are its tensors), each
    spec no longer than its tensor's dims; every cell, the GNN cell
    too, runs across ranks under its rules."""
    w, outs, ref, want = world
    trees = outs[0].get("trees")
    assert (trees is not None) == (w == 2)
    if trees is None:
        return
    for (arch, shape), (n_args, n_sh, fits, runs) in trees.items():
        assert n_args == n_sh and fits, (arch, shape)
        assert runs, (arch, shape)


def test_convert_hands_back_local_blocks(world):
    """``convert.local_blocks`` of ``dlrm_params_from_numpy``'s
    parameters under ``rules_recsys``: rank r gets rows ``[r V / w,
    (r + 1) V / w)`` of every table, and the MLPs whole."""
    w, outs, ref, want = world
    p = _payload(w)
    v = p["tables"].shape[1] // w
    for r, out in enumerate(outs):
        tables, bw0 = out["convert"]
        np.testing.assert_array_equal(tables,
                                      p["tables"][:, r * v:(r + 1) * v])
        np.testing.assert_array_equal(bw0, p["bw0"])
