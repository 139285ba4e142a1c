"""Whole-model sharded LM training of the port against the JAX package.

The five LM archs' smoke train_4k cells, built by ``steps.build_cell``
under ``rules_train_lm`` on a ``("data", "model")`` mesh of gloo ranks,
each holding its blocks of the JAX parameters (FSDP over ``data``,
heads, mlp, experts and vocab over ``model``, the residual stream's
sequence over ``model``).  One step each (``torchdist_lm_bodies.
train_case``): the loss, every gradient leaf gathered back
(``gather_blocks``), gnorm, and the updated parameters and AdamW m and v.
All five archs at mesh (2, 2); glm4-9b and granite-moe also at (1, 2),
(2, 1) and (1, 4) (the smoke configs' 2 KV heads do not split over 4
ranks: ``wk``/``wv`` are gathered whole).  glm4-9b with the ``opt``
variant, and in bf16 through the cell's own step, at (2, 2) are cases
of ``tests/test_torch_sharded_lm_cells.py`` (the two files share the
JAX references' cost).  One spawn of 4 ranks runs every mesh (the
2-rank meshes at once), started before the JAX references are
computed.

The reference is what GSPMD computes: JAX's unsharded
``value_and_grad(loss_fn)`` and ``adamw_update``, compiled fast
(``FAST_COMPILE``).  At ``|data| > 1`` the
MoE archs route each data shard's tokens on their own (JAX's mapped
``moe_block`` takes x over the data axes), so their reference loss and
gradients are the means over the data shards of JAX's on each shard's
batch; the dense archs give the same either way.

Bounds, f32 (as ``tests/test_torch_train.py``): the loss and every
gradient leaf rtol 1e-4 with atol 1e-6 against JAX; gnorm rtol 1e-5
against the port's unsharded step (its ranks sum the squares in
another order) and rtol 1e-4 against JAX; m and v (one step: 0.1 and
0.05 times the clipped gradient and its square) rtol 2e-4 with atol 1e-7
and 1e-9; the parameters atol 1e-5, except where Adam's step is
ill-conditioned (a gradient below 1e-7 RMS: its step ``g / (|g| +
eps)`` is set by f32 noise, so it may move by up to 2 lr).  bf16, against
JAX jitted: loss rtol 1e-3, each leaf atol 2e-2 and rtol 5e-2 an element
and relative L2 2e-2, gnorm rtol 2e-2.  Every rank reports the same
loss and gnorm.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch as jax_arch
from repro.models import transformer as jtf
from repro.optim import OptState as JOptState
from repro.optim import adamw_update as j_adamw
from repro.optim import cosine_schedule as j_cosine
from repro_torch.launch import steps as tsteps
from repro_torch.models.convert import transformer_params_from_numpy
from repro_torch.optim.adamw import global_norm
from repro_torch.tree import flatten_with_paths, map_tree
import torch
import torchdist
import torchdist_lm_bodies as bodies

ARCHS = ("glm4-9b", "command-r-35b", "gemma3-12b", "granite-moe-1b-a400m",
         "qwen3-moe-30b-a3b")
PAIR = ("glm4-9b", "granite-moe-1b-a400m")
F32 = dict(rtol=1e-4, atol=1e-6)
BF16 = dict(rtol=5e-2, atol=2e-2)
REL_L2 = 2e-2
B, S = 2, 64                   # the smoke train_4k cell's batch

#: (mesh, ranks, cases) a stage; the 2-rank meshes of the last run at once
STAGES = [
    [((2, 2), (0, 1, 2, 3),
      [("train", a, "base", "float32") for a in ARCHS])],
    [((1, 4), (0, 1, 2, 3),
      [("train", a, "base", "float32") for a in PAIR])],
    [((1, 2), (0, 1), [("train", a, "base", "float32") for a in PAIR]),
     ((2, 1), (2, 3), [("train", a, "base", "float32") for a in PAIR])],
]
CASES = [(shape, ranks, i, case) for stage in STAGES
         for shape, ranks, cases in stage for i, case in enumerate(cases)]


def _case_id(c):
    shape, _, _, (_, arch, variant, dtype) = c
    return f"{arch}-{shape[0]}x{shape[1]}-{variant}-{dtype}"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with torchdist.one_thread():
        yield


@functools.lru_cache(maxsize=None)
def _params_np(arch):
    """Parameters of ``arch``'s smoke config from a numpy seed, in the
    JAX tree (the port's ``init_params`` gives the leaves' shapes): the
    matrices at fan-in scale, the norm scales nonzero, so that their
    gradients show."""
    return bodies.params_np(arch, jax_arch(arch).smoke_config().vocab)


def _tokens(vocab):
    """The smoke train cell's batch (``steps._build_lm_train_cell``)."""
    toks = np.random.default_rng(0).integers(0, vocab, (B, S + 1)) \
        .astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


@pytest.fixture(scope="module")
def spawned():
    """One spawn of 4 ranks for every mesh, started with the module."""
    payload = {"params": {a: _params_np(a) for a in ARCHS},
               "stages": STAGES}
    ranks = torchdist.Ranks(4, "torchdist_lm_bodies:lm_battery", payload,
                            timeout=300.0)
    yield ranks
    ranks.close()


def _jcfg(arch, variant, dtype):
    cfg = jax_arch(arch).smoke_config()
    if variant == "opt":
        cfg = dataclasses.replace(cfg, attn_opt=True,
                                  remat_policy="block_outs")
    return dataclasses.replace(cfg, compute_dtype=getattr(jnp, dtype))


#: The references compile with XLA's passes and LLVM's lowest level,
#: about half the compile time: the same computation, rounded otherwise
#: only where a multiply and an add fuse.
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def compiled(fn, *args):
    """``jax.jit(fn)`` lowered for ``args`` and compiled fast."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)


@functools.lru_cache(maxsize=None)
def _jitted(arch, variant, dtype, rows):
    cfg = _jcfg(arch, variant, dtype)
    toks, labels = _tokens(cfg.vocab)
    return compiled(jax.value_and_grad(
        lambda p, t, l: jtf.loss_fn(p, t, l, cfg)),
        jax.tree.map(jnp.asarray, _params_np(arch)),
        jnp.asarray(toks[:rows]), jnp.asarray(labels[:rows]))


def _value_and_grad(arch, variant, dtype, rows):
    """JAX's loss and gradients on the batch rows ``rows`` (a slice)."""
    toks, labels = _tokens(_jcfg(arch, variant, dtype).vocab)
    n = rows.stop - rows.start
    loss, grads = _jitted(arch, variant, dtype, n)(
        jax.tree.map(jnp.asarray, _params_np(arch)),
        jnp.asarray(toks[rows]), jnp.asarray(labels[rows]))
    return float(loss), jax.tree.map(np.asarray, grads)


@functools.lru_cache(maxsize=None)
def _adamw(arch):
    params = jax.tree.map(jnp.asarray, _params_np(arch))
    zeros = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
    return compiled(j_adamw, params, zeros,
                    JOptState(zeros, zeros, jnp.int32(0)), jnp.float32(0))


@functools.lru_cache(maxsize=None)
def jax_step(arch, variant, dtype, n_data):
    """The reference step: (loss, grads, gnorm, params, m, v) as leaf
    lists.  The MoE archs at ``n_data`` data shards: the mean over the
    shards of JAX's loss and gradients on each shard's rows."""
    moe = jax_arch(arch).smoke_config().moe is not None
    shards = n_data if moe else 1
    per = B // shards
    runs = [_value_and_grad(arch, variant, dtype,
                            slice(i * per, (i + 1) * per))
            for i in range(shards)]
    loss = np.mean([r[0] for r in runs], dtype=np.float64)
    grads = jax.tree.map(lambda *g: np.sum(g, axis=0) / np.float32(shards),
                         *[r[1] for r in runs])
    params = jax.tree.map(jnp.asarray, _params_np(arch))
    zeros = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
    count = jnp.asarray(bodies.COUNT0, jnp.int32)
    lr = j_cosine(count, 3e-4, 2000, 200_000)
    new, opt, gnorm = _adamw(arch)(
        params, jax.tree.map(jnp.asarray, grads),
        JOptState(zeros, zeros, count), jnp.float32(lr))
    flat = lambda t: [np.asarray(a, np.float32)  # noqa: E731
                      for a in jax.tree.leaves(t)]
    return (loss, flat(grads), float(gnorm), flat(new), flat(opt.m),
            flat(opt.v), float(lr))


@functools.lru_cache(maxsize=None)
def port_step(arch, variant, n_data):
    """The port's unsharded f32 step on the same parameters and rows
    (per data shard for an MoE arch, as the reference): its gnorm."""
    cfg = bodies._cfg(arch, variant, "float32")
    params = transformer_params_from_numpy(_params_np(arch), cfg,
                                           device="cpu")
    toks, labels = (torch.from_numpy(a) for a in _tokens(cfg.vocab))
    shards = n_data if cfg.moe is not None else 1
    per = B // shards
    grads = [tsteps.lm_value_and_grad(params, toks[i * per:(i + 1) * per],
                                      labels[i * per:(i + 1) * per], cfg)[1]
             for i in range(shards)]
    mean = map_tree(lambda *g: sum(g) / shards, *grads)
    return float(global_norm(mean))


@pytest.fixture(scope="module")
def results(spawned):
    """Every case's references first (the ranks run meanwhile), then the
    ranks' results."""
    for shape, _, _, (_, arch, variant, dtype) in CASES:
        jax_step(arch, variant, dtype, shape[0])
        if dtype == "float32":
            port_step(arch, variant, shape[0])
    return spawned.results()


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_sharded_train_step_matches_jax(results, case):
    check_step(results, case)


def check_step(results, case):
    """A train case's ranks against the reference step, in the bounds of
    the module docstring."""
    shape, ranks, i, (_, arch, variant, dtype) = case
    loss, grads, gnorm, params, m, v, lr = jax_step(arch, variant, dtype,
                                                     shape[0])
    got = [results[r][shape, ranks, i] for r in ranks]
    first = got[0]
    for other in got[1:]:                   # the ranks agree
        assert other["loss"] == first["loss"]
        assert other["gnorm"] == first["gnorm"]
    assert first["count"] == bodies.COUNT0 + 1
    cfg = jax_arch(arch).smoke_config()
    np.testing.assert_array_equal(first["tokens"], _tokens(cfg.vocab)[0])
    paths = [k for k, _ in flatten_with_paths(_params_np(arch))]
    assert len(first["grads"]) == len(grads) == len(paths)
    if dtype == "bfloat16":
        np.testing.assert_allclose(first["loss"], loss, rtol=1e-3)
        np.testing.assert_allclose(first["gnorm"], gnorm, rtol=REL_L2)
        for k, g, w in zip(paths, first["grads"], grads):
            assert np.isfinite(g).all(), k
            np.testing.assert_allclose(g, w, err_msg=k, **BF16)
            assert np.linalg.norm(g - w) <= REL_L2 * np.linalg.norm(w), k
        return
    np.testing.assert_allclose(first["loss"], loss, **F32)
    np.testing.assert_allclose(first["gnorm"], gnorm, rtol=1e-4)
    np.testing.assert_allclose(first["gnorm"],
                               port_step(arch, variant, shape[0]),
                               rtol=1e-5)
    for k, g, w in zip(paths, first["grads"], grads):
        np.testing.assert_allclose(g, w, err_msg=k, **F32)
    for k, a, w in zip(paths, first["m"], m):
        np.testing.assert_allclose(a, w, rtol=2e-4, atol=1e-7,
                                   err_msg=f"m {k}")
    for k, a, w in zip(paths, first["v"], v):
        np.testing.assert_allclose(a, w, rtol=2e-4, atol=1e-9,
                                   err_msg=f"v {k}")
    p0 = jax.tree.leaves(_params_np(arch))
    for k, a, w, w0, vv in zip(paths, first["params"], params, p0, v):
        assert np.abs(w - w0).max() > 10 * 1e-5, k    # the step shows
        noisy = np.sqrt(vv / (1 - 0.95 ** (bodies.COUNT0 + 1))) < 1e-7
        err = np.abs(a - w)
        assert (err[~noisy] <= 1e-5).all(), k
        assert (err[noisy] <= 2 * lr).all(), k
