"""gemma3's sliding window in the port against the JAX package's, on the
same seeded numpy inputs, on the CPU.

* ``attention_window`` (prefill and training of local layers): f32
  within atol 1e-5 (sums in another order), bf16 within atol and rtol
  2e-2 (one last-bit flip of the rounded output), at a length that is a
  multiple of the window, one that is not (padded last chunk), one
  shorter than the window, and positions that do not start at 0; its
  f32 gradients within rtol 1e-4, atol 1e-6.
* ``attention_decode`` on a rolling cache (``window=``) before the
  cache wraps, at its last slot and after it wraps: the updated caches
  bit-equal, the output within ``test_torch_transformer.py``'s
  attention tolerances.
* A fault of the reference, pinned in both packages: JAX's ``prefill``
  keeps a local layer's last w keys at slots 0..w-1, and its decode
  writes position ``cur`` at slot ``cur % w``; after a prompt of length
  S > w with S % w != 0 decode evicts a key still inside the window and
  keeps one that has left it.  At gemma3's smoke config (w = 16), f32,
  S = 20: the port's decode equals JAX's and both differ from a prefill
  of the extended sequence (by 0.221 on the logits, on these inputs);
  at S = 32 all three agree.  The port is held to the JAX package, so
  it keeps the fault (``ROADMAP.md`` queue 3).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma3_12b as jax_gemma3
from repro.models import layers as jl
from repro.models import transformer as jtf
from repro_torch.configs import gemma3_12b
from repro_torch.kernels.flash_decode import flash_decode_ref
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import transformer_params_from_numpy

DTYPES = {"f32": (jnp.float32, torch.float32, dict(atol=1e-5, rtol=0)),
          "bf16": (jnp.bfloat16, torch.bfloat16, dict(atol=2e-2, rtol=2e-2))}
# (T, window, first position)
WINDOW_CASES = {"multiple": (64, 16, 0), "ragged": (40, 16, 0),
                "short": (10, 16, 0), "offset": (48, 16, 100)}


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _pair(arrays, jdt, tdt):
    ja = [jnp.asarray(a).astype(jdt) for a in arrays]
    ta = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
          for a in ja]
    return ja, ta


def _qkv(t, seed, b=2, h=8, kh=2, dh=16):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shp).astype(np.float32)
            for shp in ((b, t, h, dh), (b, t, kh, dh), (b, t, kh, dh))]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_attention_window_matches_jax(case, dtype):
    t, w, p0 = WINDOW_CASES[case]
    jdt, tdt, tol = DTYPES[dtype]
    ja, ta = _pair(_qkv(t, t + w), jdt, tdt)
    pos = np.arange(p0, p0 + t, dtype=np.int32)
    want = jl.attention_window(*ja, w, q_positions=jnp.asarray(pos))
    got = tl.attention_window(*ta, w, q_positions=torch.from_numpy(pos))
    assert got.dtype == tdt and got.shape == ta[0].shape
    np.testing.assert_allclose(got.float().numpy(), _np(want), **tol)


def test_attention_window_matches_a_masked_softmax():
    """Independent of both packages: position i attends (i - w, i]."""
    t, w = 37, 8
    q, k, v = (torch.from_numpy(a) for a in _qkv(t, 5))
    b, _, h, dh = q.shape
    g = h // k.shape[2]
    kk, vv = (a.repeat_interleave(g, dim=2) for a in (k, v))
    sc = torch.einsum("bthd,bshd->bhts", q * dh ** -0.5, kk)
    i = torch.arange(t)
    keep = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < w)
    p = torch.softmax(sc.masked_fill(~keep, float("-inf")), dim=-1)
    want = torch.einsum("bhts,bshd->bthd", p, vv)
    torch.testing.assert_close(tl.attention_window(q, k, v, w), want,
                               atol=1e-5, rtol=0)


def test_attention_window_grads_match_jax():
    t, w = 40, 16
    arrays = _qkv(t, 7)
    g = np.random.default_rng(8).normal(size=arrays[0].shape).astype(
        np.float32)
    want = jax.grad(lambda q, k, v: jnp.sum(jl.attention_window(
        q, k, v, w) * g), argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = tl.attention_window(*ts, w)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), ts)
    for name, a, b in zip("qkv", got, want):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cur_len", [5, 15, 16, 37])
def test_rolling_attention_decode_matches_jax(cur_len, dtype):
    """A 16-slot rolling cache: before it wraps (5), at its last slot
    (15), at the first wrap (16) and later (37).  The output within
    atol 2e-5 in f32, 2e-2 in bf16; both caches bit-equal."""
    jdt, tdt, _ = DTYPES[dtype]
    tol = dict(atol=2e-5, rtol=0) if dtype == "f32" else \
        dict(atol=2e-2, rtol=2e-2)
    w, b, h, kh, dh = 16, 2, 8, 2, 16
    rng = np.random.default_rng(cur_len)
    arrays = [rng.normal(size=shp).astype(np.float32) for shp in (
        (b, h, dh), (b, w, kh, dh), (b, w, kh, dh), (b, kh, dh), (b, kh, dh))]
    ja, ta = _pair(arrays, jdt, tdt)
    j_out, j_k, j_v = jl.attention_decode(*ja, jnp.int32(cur_len), window=w)
    t_out, t_k, t_v = tl.attention_decode(*ta, cur_len, window=w)
    assert t_k is ta[1] and t_v is ta[2]                 # updated in place
    np.testing.assert_allclose(t_out.float().numpy(), _np(j_out), **tol)
    np.testing.assert_array_equal(t_k.float().numpy(), _np(j_k))
    np.testing.assert_array_equal(t_v.float().numpy(), _np(j_v))
    # the slot written and the slots read
    slot = cur_len % w
    assert torch.equal(t_k[:, slot], ta[3])
    want = flash_decode_ref(ta[0], t_k, t_v, min(cur_len, w - 1) + 1)
    torch.testing.assert_close(t_out.float(), want.to(tdt).float(),
                               atol=0, rtol=0)


@functools.lru_cache(maxsize=None)
def _gemma3_pair():
    jcfg = dataclasses.replace(jax_gemma3.smoke_config(),
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(gemma3_12b.smoke_config(),
                               compute_dtype=torch.float32)
    jp = jax.jit(jtf.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                     jcfg)
    tp = transformer_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                       device="cpu")
    return jcfg, tcfg, jp, tp


def _decode_after_prompt(s):
    """(port decode logits, JAX decode logits, port prefill of the
    extended sequence) after a prompt of ``s`` tokens, f32."""
    jcfg, tcfg, jp, tp = _gemma3_pair()
    b, cache_len = 2, s + 8
    toks = np.random.default_rng(s).integers(0, tcfg.vocab, (b, s)) \
        .astype(np.int32)
    j_logits, j_part = jtf.prefill(jp, jnp.asarray(toks), jcfg)
    t_logits, t_part = ttf.prefill(tp, torch.from_numpy(toks), tcfg)
    nxt = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)
    assert (t_logits.argmax(-1).numpy() == nxt).all()
    j_full = jax.tree.map(lambda full, part: full.at[:, :, :s].set(part),
                          jtf.make_cache(jcfg, b, cache_len,
                                         dtype=jnp.float32), j_part)
    j_dec, _ = jtf.decode_step(jp, j_full, jnp.asarray(nxt), jnp.int32(s),
                               jcfg)
    t_full = ttf.make_cache(tcfg, b, cache_len, dtype=torch.float32,
                            device="cpu")
    for full, part in zip(t_full, t_part):
        full["k"][:, :, :s] = part["k"]
        full["v"][:, :, :s] = part["v"]
    t_dec, _ = ttf.decode_step(tp, t_full, torch.from_numpy(nxt), s, tcfg)
    ext = np.concatenate([toks, nxt[:, None]], axis=1)
    t_ext, _ = ttf.prefill(tp, torch.from_numpy(ext), tcfg)
    return t_dec.numpy(), _np(j_dec), t_ext.numpy()


@pytest.mark.parametrize("s,faulty", [(20, True), (32, False), (12, False)])
def test_rolling_cache_after_prefill_as_the_reference_does(s, faulty):
    """The reference's fault, pinned: at S = 20 (> w, S % w = 4) decode
    differs from a prefill of the extended sequence in both packages,
    the port as JAX; at S = 32 (a multiple of w) and S = 12 (within the
    window) all three agree within atol 1e-4."""
    port, ref, ext = _decode_after_prompt(s)
    np.testing.assert_allclose(port, ref, atol=1e-4, rtol=0)
    gap = np.abs(port - ext).max()
    if faulty:
        assert gap > 0.1, gap
        assert np.abs(ref - ext).max() > 0.1
    else:
        assert gap <= 1e-4, gap
