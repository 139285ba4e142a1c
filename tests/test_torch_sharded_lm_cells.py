"""The other whole-model sharded LM cells of the port: glm4-9b's train
step with the ``opt`` variant and in bf16, prefill and decode against
the JAX package, the sharded cells at world size 1 against the
unsharded ones, and the production layouts.  (The GNN and recsys train
cells, which refused a mesh before, run on one in
``tests/test_torch_sharded_gnn.py`` and
``tests/test_torch_sharded_recsys.py``.)

Train variants (``torchdist_lm_bodies.train_case``): glm4-9b's smoke
train_4k cell under ``rules_train_lm`` at mesh (2, 2), with the ``opt``
variant (``attn_opt`` and the ``block_outs`` remat policy) in f32, and
in bf16 through the cell's own step; held to JAX's unsharded step
(``value_and_grad`` of the same config, ``adamw_update``) in the bounds
of ``tests/test_torch_sharded_lm.py``, whose checks they share.

Serving (``serve_case``): glm4-9b, gemma3-12b and qwen3-moe in f32
under ``rules_serve_lm`` at meshes (1, 2) and (2, 2) of gloo ranks: a
prefill of 16 tokens (gemma3's prompt within its smoke window of 16,
``ROADMAP.md`` queue 3), its caches laid into 32-slot caches split over
``model``, then two decode steps.  The reference is JAX's unsharded
``prefill`` and ``decode_step``; at ``|data| > 1`` the MoE arch routes
each data shard's tokens on their own (JAX's mapped ``moe_block`` takes
x over the data axes), so its reference runs each shard's rows alone.
Bounds: the logits atol 1e-5; the caches (a product and RoPE, no sums
across ranks) atol 1e-5 against JAX's, and the prefill's bit for bit
where decode leaves them.

World size 1 (``world1_case``, a one-rank mesh): glm4-9b's smoke
train_4k and decode_32k cells, sharded and unsharded from the same
seed.  One rank runs every collective over groups of one, which leave
each tensor as it is: the loss, gnorm, state, logits and caches are
bit for bit the unsharded cells'.

One spawn of 4 ranks runs the (2, 2) mesh, then the (1, 2) mesh and
the one-rank mesh at once, started before the JAX references are
computed.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch as jax_arch
from repro.models import transformer as jtf
from repro_torch import shardlib as sl
from repro_torch.configs import get_arch
from repro_torch.configs.shapes import SHAPE_PARAMS
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps
from repro_torch.models import transformer as tf
from repro_torch.tree import leaves
import torchdist
import torchdist_lm_bodies as bodies
from test_torch_sharded_lm import (_case_id, check_step, compiled, jax_step,
                                   port_step)

SERVE = ("glm4-9b", "gemma3-12b", "qwen3-moe-30b-a3b")
ARCHS = ("glm4-9b", "command-r-35b", "gemma3-12b", "granite-moe-1b-a400m",
         "qwen3-moe-30b-a3b")
B, P, CACHE = bodies.SERVE_B, bodies.PROMPT, bodies.CACHE

VARIANTS = [("train", "glm4-9b", "opt", "float32"),
            ("train", "glm4-9b", "base", "bfloat16")]
STAGES = [
    [((2, 2), (0, 1, 2, 3), VARIANTS + [("serve", a) for a in SERVE])],
    [((1, 2), (0, 1), [("serve", a) for a in SERVE]),
     ((1, 1), (2,), [("world1",)])],
]
SERVE_CASES = [(shape, ranks, i, case[1]) for stage in STAGES
               for shape, ranks, cases in stage
               for i, case in enumerate(cases) if case[0] == "serve"]
TRAIN_CASES = [((2, 2), (0, 1, 2, 3), i, case)
               for i, case in enumerate(VARIANTS)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with torchdist.one_thread():
        yield


@functools.lru_cache(maxsize=None)
def _params_np(arch):
    return bodies.params_np(arch, jax_arch(arch).smoke_config().vocab)


def _inputs():
    rng = np.random.default_rng(25)
    vocab = 512                                   # every smoke config's
    return (rng.integers(0, vocab, (B, P)).astype(np.int32),
            [rng.integers(0, vocab, B).astype(np.int32) for _ in range(2)])


@pytest.fixture(scope="module")
def spawned():
    prompt, nxt = _inputs()
    payload = {"params": {a: _params_np(a) for a in SERVE},
               "stages": STAGES, "prompt": prompt, "next": nxt}
    ranks = torchdist.Ranks(4, "torchdist_lm_bodies:lm_battery", payload,
                            timeout=300.0)
    yield ranks
    ranks.close()


@functools.lru_cache(maxsize=None)
def _serve_fns(arch, b):
    """JAX's prefill and decode_step for ``b`` rows, compiled fast (as
    ``tests/test_torch_sharded_lm.py`` compiles its references)."""
    cfg = dataclasses.replace(jax_arch(arch).smoke_config(),
                              compute_dtype=jnp.float32)
    params = jax.tree.map(jnp.asarray, _params_np(arch))
    toks = jnp.zeros((b, P), jnp.int32)
    caches = jtf.make_cache(cfg, b, CACHE, dtype=jnp.float32)
    return (cfg,
            compiled(lambda p, t: jtf.prefill(p, t, cfg), params, toks),
            compiled(lambda p, c, t, n: jtf.decode_step(p, c, t, n, cfg),
                     params, caches, toks[:, 0], jnp.int32(P)))


def _jax_serve(arch, rows):
    """JAX's prefill of the rows ``rows`` of the prompt, its caches laid
    into ``CACHE`` slots, and two decode steps."""
    cfg, prefill, decode = _serve_fns(arch, rows.stop - rows.start)
    prompt, nxt = _inputs()
    params = jax.tree.map(jnp.asarray, _params_np(arch))
    logits, caches = prefill(params, jnp.asarray(prompt[rows]))
    out = {"prefill": np.asarray(logits),
           "prefill_caches": [np.asarray(a) for a in jax.tree.leaves(caches)]}
    full = jax.tree.map(
        lambda whole, part: whole.at[:, :, :part.shape[2]].set(part),
        jtf.make_cache(cfg, rows.stop - rows.start, CACHE,
                       dtype=jnp.float32), caches)
    for i, n in enumerate(nxt):
        logits, full = decode(params, full, jnp.asarray(n[rows]),
                              jnp.int32(P + i))
        out[f"decode{i}"] = np.asarray(logits)
    out["decode_caches"] = [np.asarray(a) for a in jax.tree.leaves(full)]
    return out


@functools.lru_cache(maxsize=None)
def jax_serve(arch, n_data):
    """The reference: the whole batch, or for the MoE arch each data
    shard's rows on their own, joined along the batch."""
    moe = jax_arch(arch).smoke_config().moe is not None
    shards = n_data if moe else 1
    per = B // shards
    runs = [_jax_serve(arch, slice(i * per, (i + 1) * per))
            for i in range(shards)]
    out = {}
    for k, v in runs[0].items():
        if isinstance(v, list):               # caches: batch on axis 1
            out[k] = [np.concatenate([r[k][j] for r in runs], axis=1)
                      for j in range(len(v))]
        else:
            out[k] = np.concatenate([r[k] for r in runs], axis=0)
    return out


@pytest.fixture(scope="module")
def results(spawned):
    """Every case's reference first (the ranks run meanwhile), then the
    ranks' results."""
    for shape, _, _, (_, arch, variant, dtype) in TRAIN_CASES:
        jax_step(arch, variant, dtype, shape[0])
        if dtype == "float32":
            port_step(arch, variant, shape[0])
    for shape, _, _, arch in SERVE_CASES:
        jax_serve(arch, shape[0])
    return spawned.results()


@pytest.mark.parametrize("case", TRAIN_CASES, ids=_case_id)
def test_sharded_train_variants_match_jax(results, case):
    check_step(results, case)


@pytest.mark.parametrize("case", SERVE_CASES,
                         ids=lambda c: f"{c[3]}-{c[0][0]}x{c[0][1]}")
def test_sharded_prefill_and_decode_match_jax(results, case):
    shape, ranks, i, arch = case
    want = jax_serve(arch, shape[0])
    got = results[ranks[0]][shape, ranks, i]
    for k in ("prefill", "decode0", "decode1"):
        assert got[k].shape == want[k].shape == (B, 512), k
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0,
                                   err_msg=k)
    for k in ("prefill_caches", "decode_caches"):
        assert len(got[k]) == len(want[k])
        for j, (g, w) in enumerate(zip(got[k], want[k])):
            assert g.shape == w.shape, (k, j)
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0,
                                       err_msg=f"{k} {j}")
    # decode writes slots 16 and 17 (a local layer's ring: 0 and 1)
    for j, (pre, dec) in enumerate(zip(got["prefill_caches"],
                                       got["decode_caches"])):
        kept = slice(2, P) if pre.shape[2] == dec.shape[2] else slice(0, P)
        np.testing.assert_array_equal(dec[:, :, kept], pre[:, :, kept])


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_world_one_cells_equal_the_unsharded(results, shape):
    sharded, plain = results[2][(1, 1), (2,), 0][shape]
    if shape == "train_4k":
        assert sharded["loss"] == plain["loss"]
        assert sharded["gnorm"] == plain["gnorm"]
        got, want = sharded["state"], plain["state"]
    else:
        got = [sharded["logits"]] + sharded["caches"]
        want = [plain["logits"]] + plain["caches"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# The production layouts, from shapes alone
# ---------------------------------------------------------------------------

class _Mesh:
    """The production mesh's names and sizes, all that rule resolution
    reads (no group, no card)."""

    def __init__(self):
        (self.shape, self.mesh_dim_names) = tmesh.production_mesh_shape()

    def size(self, dim=None):
        return (int(np.prod(self.shape)) if dim is None
                else self.shape[dim])


def _shapes(cfg, kind, batch, seq):
    """The shapes of a cell's arguments, as meta tensors."""
    meta = lambda *s: __import__("torch").empty(s, device="meta")  # noqa
    shp = tf._layer_shapes(cfg)
    params = {"embed": meta(cfg.vocab, cfg.d_model), "ln_f": meta(cfg.d_model),
              "layers": [{k: meta(cfg.n_cycles, *v) for k, v in shp.items()}
                         for _ in range(cfg.local_global_period)]}
    if not cfg.tie_embeddings:
        params["head"] = meta(cfg.d_model, cfg.vocab)
    if kind != "decode":
        return params, meta(batch, seq)
    caches = []
    for pos in range(cfg.local_global_period):
        s = (min(cfg.sliding_window, seq) if cfg.layer_is_local(pos)
             else seq)
        c = meta(cfg.n_cycles, batch, s, cfg.n_kv_heads, cfg.hd)
        caches.append({"k": c, "v": c})
    return params, caches, meta(batch)


def _splits(t, spec, mesh):
    return all(t.shape[d] % sl.axis_size(sl._axes_tuple(part), mesh) == 0
               for d, part in enumerate(tuple(spec)))


@pytest.mark.parametrize("arch", ARCHS)
def test_production_layouts_split_evenly(arch):
    """Each arch's published config on the (16, 16) mesh under
    ``rules_train_lm`` (train_4k) and ``rules_serve_lm`` (its serving
    cells): every leaf of ``in_shardings`` splits evenly; heads, d_ff or
    experts, vocab and the sequence split over 16, D over 16 for FSDP;
    no arch's KV heads split over 16, and the KV rule gives every rank
    the KV heads its query heads read."""
    mod = get_arch(arch)
    cfg = mod.CONFIG
    mesh = _Mesh()
    n = 16
    assert cfg.n_heads % n == 0 and cfg.vocab % n == 0
    assert cfg.d_model % n == 0
    assert (cfg.moe.n_experts if cfg.moe else cfg.d_ff) % n == 0
    assert cfg.n_kv_heads % n != 0
    g = cfg.n_heads // cfg.n_kv_heads
    for i in range(n):
        h_l, q_lo, gather, (lo, hi) = tf._kv_heads(
            cfg, tf._Layout(n_tp=n, i_tp=i))
        assert gather and lo == q_lo // g and hi == (q_lo + h_l - 1) // g + 1
        assert h_l % (hi - lo) == 0
    for shape, sp in SHAPE_PARAMS["lm"].items():
        if shape in getattr(mod, "SKIP_SHAPES", {}):
            continue
        kind, b, s = sp["kind"], sp["global_batch"], sp["seq_len"]
        assert s % n == 0
        with sl.axis_rules(mesh, steps.rules_for(arch, shape, mesh)):
            psh = steps._resolve(tf.param_shardings(cfg))
            if kind == "train":
                tree = (_shapes(cfg, kind, b, s)[0],) * 3 + (
                    _shapes(cfg, kind, b, s)[1],)
                specs = (psh, psh, psh, sl.sharding_for("batch", None))
                assert sl.logical_to_spec("fsdp") == ("data",)
            elif kind == "prefill":
                tree = _shapes(cfg, kind, b, s)
                specs = (psh, sl.sharding_for("batch", None))
            else:
                tree = _shapes(cfg, kind, b, s)
                specs = (psh, steps._resolve(tf.cache_shardings(cfg)),
                         sl.sharding_for("batch"))
            ts, ss = leaves(tree), leaves(specs)
            assert len(ts) == len(ss), shape
            for t, sh in zip(ts, ss):
                assert _splits(t, sh.spec, mesh), (shape, tuple(t.shape),
                                                   sh.spec)
