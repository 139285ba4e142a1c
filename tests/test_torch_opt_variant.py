"""The optimized LM variant of the port against the JAX package's: its
training attention (``attention_causal_opt``), the model trained with
``attn_opt`` and the ``block_outs`` remat policy, and
``build_cell(..., variant="opt")``.  Inputs from numpy seeds; JAX
weights carried across by ``models/convert.py``.

Tolerances, each with its reason:

* ``attention_causal_opt`` in f32, output and the gradients of q, k
  and v (a random cotangent): atol 1e-5.  The two differ only in the
  order of f32 sums (measured at most 1.3e-6 on the output, 1.9e-6 on a
  gradient, at dh 256).
* The same in bf16, against JAX run op by op (``jax.disable_jit``,
  which rounds after each operation as written, as the port does):
  atol 2e-2 and rtol 5e-2 an element, and a relative L2 error of 2e-2
  a tensor, the repo's bf16 bounds (``tests/test_torch_transformer.py``).
  Measured: the output bit for bit; the gradients' worst element 0.0625
  (dk and dv at G 16, one bf16 step at magnitudes up to 12.9) and
  relative L2 at most 6.9e-3.  The f32 sums of the products and of
  ``p`` round to the same bf16 almost always, and a flipped bit of
  ``p`` moves a gradient by a step.
* The model's loss and gradients with ``attn_opt`` and ``block_outs``:
  ``tests/test_torch_train.py``'s bounds (f32: loss rtol 1e-5, leaves
  rtol 1e-4 with atol 1e-6; bf16 op by op: loss rtol 1e-3, leaves atol
  2e-2, rtol 5e-2, relative L2 2e-2).  Measured in bf16 on glm4's smoke
  config: the loss 5.4e-5 apart relative, the leaves' relative L2 at
  most 1.2e-2 (the first layer's norm scale).
* ``prefill`` with and without ``attn_opt``: bit for bit (prefill keeps
  ``attention_causal``, as JAX's does).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models import layers as jl
from repro.models import transformer as jtf
from repro_torch.configs import get_arch
from repro_torch.launch import steps as tsteps
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import transformer_params_from_numpy
from repro_torch.tree import flatten_with_paths, leaves

KEY = jax.random.PRNGKey(0)
LM_ARCHS = ("glm4-9b", "command-r-35b", "gemma3-12b",
            "granite-moe-1b-a400m", "qwen3-moe-30b-a3b")
# (b, t, h, kh, dh, chunk): tests/test_perf_variants.py's three, glm4's
# G of 16 and gemma3's global dh of 256, ragged tails among them
ATTN_SHAPES = [(2, 48, 8, 2, 16, 16), (1, 65, 4, 4, 8, 32),
               (2, 64, 16, 8, 16, 16), (1, 40, 16, 1, 8, 16),
               (1, 33, 4, 2, 256, 16)]
BF16_BOUNDS = dict(atol=2e-2, rtol=5e-2)
REL_L2 = 2e-2
LM_S, LM_CHUNK = 48, 16


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _attn_inputs(shape):
    b, t, h, kh, dh, _ = shape
    rng = np.random.default_rng(sum(shape))
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, t, h, dh), (b, t, kh, dh), (b, t, kh, dh),
                      (b, t, h, dh))]


def _attn_pair(shape, jdt, tdt, op_by_op):
    """(JAX's output and q/k/v gradients, the port's), as float arrays."""
    q, k, v, ct = _attn_inputs(shape)
    chunk = shape[-1]
    with jax.disable_jit(op_by_op):
        out, vjp = jax.vjp(
            lambda *a: jl.attention_causal_opt(*a, chunk=chunk),
            *(jnp.asarray(a, jdt) for a in (q, k, v)))
        want = [out, *vjp(jnp.asarray(ct, jdt))]
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_(True)
                  for a in (q, k, v))
    o = tl.attention_causal_opt(tq, tk, tv, chunk=chunk)
    assert o.dtype == tdt
    o.backward(torch.from_numpy(ct).to(tdt))
    got = [o.detach(), tq.grad, tk.grad, tv.grad]
    return ([_np(w) for w in want], [g.float().numpy() for g in got])


@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_attention_opt_f32_matches_jax(shape):
    want, got = _attn_pair(shape, jnp.float32, torch.float32, False)
    for what, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=what)


def test_attention_opt_bf16_matches_jax_op_by_op():
    """G 16 with a ragged tail: the flat heads' repeat, the bf16 ``p``
    and its row sum, in both directions."""
    want, got = _attn_pair(ATTN_SHAPES[3], jnp.bfloat16, torch.bfloat16,
                           True)
    for what, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=what, **BF16_BOUNDS)
        assert np.linalg.norm(g - w) <= REL_L2 * np.linalg.norm(w), what


def test_attention_opt_positions_and_padded_rows():
    """Explicit positions as the model passes them; padded query rows
    (position -1) see no key, and the backward stays finite."""
    shape = ATTN_SHAPES[1]
    q, k, v, _ = (torch.from_numpy(a).requires_grad_(True)
                  for a in _attn_inputs(shape))
    pos = torch.arange(shape[1], dtype=torch.int32)
    out = tl.attention_causal_opt(q, k, v, chunk=shape[-1], q_positions=pos,
                                  kv_positions=pos)
    assert torch.equal(out, tl.attention_causal_opt(q, k, v,
                                                    chunk=shape[-1]))
    out.sum().backward()
    assert all(torch.isfinite(a.grad).all() for a in (q, k, v))


@functools.lru_cache(maxsize=None)
def _params_np(arch):
    jp = jax.jit(jtf.init_params, static_argnums=1)(
        KEY, jax_arch(arch).smoke_config())
    return jax.tree.map(np.asarray, jp)


def _opt(cfg, **kw):
    return dataclasses.replace(cfg, attn_opt=True, remat_policy="block_outs",
                               loss_chunk=LM_CHUNK, **kw)


@pytest.mark.parametrize("arch,dtype", [("glm4-9b", "f32"),
                                        ("gemma3-12b", "f32"),
                                        ("glm4-9b", "bf16")])
def test_opt_model_loss_and_grads_match_jax(arch, dtype):
    """``loss_fn`` and every gradient with ``attn_opt`` and ``block_outs``
    against ``jax.value_and_grad`` at a length (48) that pads the last
    attention chunk (32); gemma3's global layers take the opt attention
    and its local ones the window."""
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jcfg = _opt(jax_arch(arch).smoke_config(), compute_dtype=jdt)
    tcfg = _opt(get_arch(arch).smoke_config(), compute_dtype=tdt)
    np_params = _params_np(arch)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tcfg.vocab, (2, LM_S)).astype(np.int32)
    labels = rng.integers(0, tcfg.vocab, (2, LM_S)).astype(np.int32)
    with jax.disable_jit(dtype == "bf16"):
        jl_, jg = jax.value_and_grad(lambda p: jtf.loss_fn(
            p, jnp.asarray(toks), jnp.asarray(labels), jcfg))(
                jax.tree.map(jnp.asarray, np_params))
    tp = transformer_params_from_numpy(np_params, tcfg, device="cpu")
    tl_, tg = tsteps.lm_value_and_grad(tp, torch.from_numpy(toks),
                                       torch.from_numpy(labels), tcfg)
    np.testing.assert_allclose(tl_.item(), float(jl_),
                               rtol=1e-5 if dtype == "f32" else 1e-3)
    tol = (dict(rtol=1e-4, atol=1e-6) if dtype == "f32" else BF16_BOUNDS)
    for (k, g), w in zip(flatten_with_paths(tg), jax.tree.leaves(jg)):
        got, want = g.numpy(), _np(w)
        np.testing.assert_allclose(got, want, err_msg=k, **tol)
        if dtype == "bf16":
            assert np.linalg.norm(got - want) <= REL_L2 * np.linalg.norm(
                want), k


@pytest.mark.parametrize("arch", ["glm4-9b", "gemma3-12b"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_ignores_attn_opt(arch, dtype):
    """``prefill``'s logits and caches are the same bits with and
    without ``attn_opt`` (and ``block_outs``)."""
    cfg = dataclasses.replace(get_arch(arch).smoke_config(),
                              compute_dtype=dtype)
    params = transformer_params_from_numpy(_params_np(arch), cfg,
                                           device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 40)).astype(np.int32))
    base, base_caches = ttf.prefill(params, toks, cfg)
    opt, opt_caches = ttf.prefill(params, toks, _opt(cfg))
    assert torch.equal(base, opt)
    for a, b in zip(leaves(base_caches), leaves(opt_caches)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_opt_cell_config(arch):
    """The published config of ``variant="opt"`` trains with
    ``attn_opt`` and ``block_outs`` (the JAX ``_OptLM``), and nothing
    else changes; its smoke config is the base one."""
    base = tsteps.lm_cell_config(arch)
    opt = tsteps.lm_cell_config(arch, variant="opt")
    assert opt.attn_opt and opt.remat_policy == "block_outs"
    assert not base.attn_opt and base.remat_policy == "none"
    assert dataclasses.replace(opt, attn_opt=False,
                               remat_policy="none") == base
    assert tsteps.lm_cell_config(arch, smoke=True, variant="opt") == \
        get_arch(arch).smoke_config()
    assert tsteps._lm_flops(opt, "train", 256, 4096) == \
        tsteps._lm_flops(base, "train", 256, 4096)


def test_opt_smoke_cell_equals_base():
    """``build_cell(..., smoke=True, variant="opt")`` is the base smoke
    cell (as in JAX, where ``_OptLM`` keeps ``smoke_config``): the same
    config, weights and batch, and one step gives the same bits; the
    cell records its variant and cuts."""
    cells = [tsteps.build_cell("glm4-9b", "train_4k", smoke=True,
                               device="cpu", variant=v)
             for v in ("base", "opt")]
    assert cells[0].meta["cfg"] == cells[1].meta["cfg"]
    assert [c.meta["variant"] for c in cells] == ["base", "opt"]
    outs = [c.run()[1] for c in cells]
    assert torch.equal(outs[0]["loss"], outs[1]["loss"])
    for a, b in zip(leaves(cells[0].args[0]), leaves(cells[1].args[0])):
        assert torch.equal(a, b)
    cut = tsteps.build_cell("gemma3-12b", "train_4k", smoke=True,
                            device="cpu", variant="opt", layers=3, batch=1)
    assert cut.meta["reduced"] == {"n_layers": [6, 3], "batch": [2, 1]}
    assert cut.meta["variant"] == "opt"
