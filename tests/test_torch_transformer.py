"""The port's LM serving path against the JAX package's, at the smoke
configs of all five LM archs (glm4-9b and command-r-35b dense,
gemma3-12b's sliding window with its rolling caches, granite-moe and
qwen3-moe), with the JAX weights carried across by
``models/convert.py``.

* f32 compute: prefill logits and caches, and one decode step's logits
  and caches, within atol 1e-4: the two packages then differ only in the
  order of f32 sums, so this catches logic faults.
* bf16 compute (the serving dtype): atol 2e-2 and rtol 5e-2 on every
  logit, a relative L2 error (||port - jax|| / ||jax||) of at most
  2e-2 over all of them, and the greedy tokens equal.  The port rounds where JAX does (norm scales cast
  to bf16, q scaled in bf16, RoPE in f32, silu one operation at a time),
  and the layers agree bit for bit until a last-bit flip appears (libm's
  cos/sin differ from XLA's in ~5% of f32 values, and matmuls sum in
  another order); two bf16 layers spread such a flip to ~1% relative
  noise on the logits (9 of 1024 prefill logits differ by more than
  2e-2, at most 0.0244).  JAX disagrees with itself by as much: its
  jitted prefill and the same prefill run op by op
  (``jax.disable_jit``) differ by 0.0244 on these inputs.
  The K/V caches get atol one bf16 ulp of their largest value (2^-7 of
  it): RoPE takes differences of two such values, so a flipped input
  bit shows up undiminished on an output near zero.
  The four archs after glm4 are held in bf16 to the JAX functions run
  op by op (``jax.disable_jit``), which round after every operation as
  written, as the port does: XLA's fusion in the jitted scan drops some
  of those roundings, and on an MoE arch one flipped bit of a hidden
  state flips a top-k choice (qwen3-moe's smoke prefill: a margin of
  3e-4, a logit moved by 0.56, against 0 op by op).
* Decode against a prefill of the extended sequence holds only when no
  MoE layer drops a token: prefill routes B x (S + 1) tokens and decode
  B, at different capacities.  The MoE archs run that check at a
  capacity factor of E / k (nothing drops).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.configs import glm4_9b as jax_glm4
from repro.models import layers as jl
from repro.models import transformer as jtf
from repro_torch.configs import get_arch
from repro_torch.configs import glm4_9b
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import transformer_params_from_numpy

B, S, S_CACHE = 2, 64, 80
DTYPES = {"f32": (jnp.float32, torch.float32, dict(atol=1e-4, rtol=0)),
          "bf16": (jnp.bfloat16, torch.bfloat16, dict(atol=2e-2, rtol=5e-2))}
LM_ARCHS = ("glm4-9b", "command-r-35b", "gemma3-12b",
            "granite-moe-1b-a400m", "qwen3-moe-30b-a3b")
# glm4's cases keep their ids ("f32", "bf16"); the others' name the arch
RUNS = [(a, d) for a in LM_ARCHS for d in DTYPES]


def _run_id(run):
    arch, dtype = run
    return dtype if arch == "glm4-9b" else f"{arch}-{dtype}"


def _no_drops(cfg):
    """``cfg`` with a capacity factor of E / k: every expert has room
    for every token, so no MoE layer drops one."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, tol):
    """The logits' tolerance; in bf16 also the relative L2 bound, which
    ``chip_smoke.py`` grows with the depth for the 40-layer model."""
    np.testing.assert_allclose(got, want, **tol)
    if tol["rtol"]:
        assert np.linalg.norm(got - want) <= 2e-2 * np.linalg.norm(want)


def _cache_tol(tol, ref):
    """bf16 caches: atol one ulp at the cache's largest magnitude (2^-7
    of it), never below 2e-2, rtol 2e-2; f32: the logits' tolerance."""
    if tol["rtol"] == 0:
        return tol
    return dict(rtol=2e-2,
                atol=max(tol["atol"], 2.0 ** -7 * np.abs(ref).max()))


def _torch(a, dtype):
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))
                            ).to(dtype)


@functools.lru_cache(maxsize=None)
def _jax_params_np(arch="glm4-9b"):
    """The JAX smoke params as numpy, drawn once (in one jit) for both
    dtypes: the compute dtype does not enter the init."""
    jp = jax.jit(jtf.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jax_arch(arch).smoke_config())
    return jax.tree.map(np.asarray, jp)


def _t_serve(tp, tcfg, toks, nxt, tdt):
    """The port's prefill of ``toks`` [B, S], then one decode step of
    ``nxt`` into an S_CACHE-slot cache."""
    t_logits, t_caches = ttf.prefill(tp, torch.from_numpy(toks), tcfg)
    t_full = ttf.make_cache(tcfg, B, S_CACHE, dtype=tdt, device="cpu")
    for full, part in zip(t_full, t_caches):
        full["k"][:, :, :S] = part["k"]
        full["v"][:, :, :S] = part["v"]
    t_dec, t_dec_caches = ttf.decode_step(tp, t_full, torch.from_numpy(nxt),
                                          S, tcfg)
    return t_logits, t_caches, t_dec, t_dec_caches


@pytest.fixture(scope="module", params=RUNS, ids=_run_id)
def runs(request):
    """Prefill of B x S tokens, then one greedy decode step into an
    S_CACHE-slot cache, in both packages."""
    arch, dtype = request.param
    jdt, tdt, tol = DTYPES[dtype]
    jcfg = dataclasses.replace(jax_arch(arch).smoke_config(),
                               compute_dtype=jdt)
    tcfg = dataclasses.replace(get_arch(arch).smoke_config(),
                               compute_dtype=tdt)
    # the serving cast, on the host
    jp = jax.tree.map(lambda a: jnp.asarray(a.astype(jdt)),
                      _jax_params_np(arch))
    tp = transformer_params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a).astype(np.float32), jp), tcfg,
        device="cpu", dtype=tdt)
    toks = np.random.default_rng(0).integers(0, tcfg.vocab, (B, S)) \
        .astype(np.int32)

    with jax.disable_jit(arch != "glm4-9b" and dtype == "bf16"):
        j_logits, j_caches = jtf.prefill(jp, jnp.asarray(toks), jcfg)
        nxt = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)
        j_full = jax.tree.map(
            lambda full, part: full.at[:, :, :S].set(part),
            jtf.make_cache(jcfg, B, S_CACHE, dtype=jdt), j_caches)
        j_dec, j_dec_caches = jtf.decode_step(jp, j_full, jnp.asarray(nxt),
                                              jnp.int32(S), jcfg)
    t_logits, t_caches, t_dec, t_dec_caches = _t_serve(tp, tcfg, toks, nxt,
                                                       tdt)
    return dict(tol=tol, tcfg=tcfg, tp=tp, toks=toks, nxt=nxt, tdt=tdt,
                j_logits=j_logits, t_logits=t_logits, j_caches=j_caches,
                t_caches=t_caches, j_dec=j_dec, t_dec=t_dec,
                j_dec_caches=j_dec_caches, t_dec_caches=t_dec_caches)


def test_prefill_matches_jax(runs):
    _close(runs["t_logits"].numpy(), _np(runs["j_logits"]), runs["tol"])
    for j, t in zip(runs["j_caches"], runs["t_caches"]):
        for name in ("k", "v"):
            assert t[name].dtype == runs["tcfg"].compute_dtype
            ref = _np(j[name])
            np.testing.assert_allclose(t[name].float().numpy(), ref,
                                       **_cache_tol(runs["tol"], ref))
    np.testing.assert_array_equal(runs["t_logits"].argmax(-1).numpy(),
                                  np.asarray(runs["j_logits"].argmax(-1)))


def test_decode_step_matches_jax(runs):
    _close(runs["t_dec"].numpy(), _np(runs["j_dec"]), runs["tol"])
    np.testing.assert_array_equal(runs["t_dec"].argmax(-1).numpy(),
                                  np.asarray(runs["j_dec"].argmax(-1)))
    for j, t in zip(runs["j_dec_caches"], runs["t_dec_caches"]):
        for name in ("k", "v"):
            ref = _np(j[name])
            np.testing.assert_allclose(t[name].float().numpy(), ref,
                                       **_cache_tol(runs["tol"], ref))
            assert not t[name][:, :, S + 1:].any()      # nothing past slot S


def test_decode_equals_prefill_of_the_extended_sequence(runs):
    """The port alone: the decode step's logits equal the last-position
    logits of a prefill over the sequence with the new token appended
    (``tests/test_models.py``'s check, here against prefill); an MoE
    arch's prefill and decode rerun with no drops."""
    cfg, dec = runs["tcfg"], runs["t_dec"]
    if cfg.moe is not None:
        cfg = _no_drops(cfg)
        dec = _t_serve(runs["tp"], cfg, runs["toks"], runs["nxt"],
                       runs["tdt"])[2]
    toks2 = np.concatenate([runs["toks"], runs["nxt"][:, None]], axis=1)
    ref, _ = ttf.prefill(runs["tp"], torch.from_numpy(toks2), cfg)
    _close(dec.numpy(), ref.numpy(), runs["tol"])
    np.testing.assert_array_equal(dec.argmax(-1).numpy(),
                                  ref.argmax(-1).numpy())


@pytest.mark.parametrize("cur_len", [0, 17, 47])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attention_decode_matches_jax(cur_len, dtype):
    """The output within the dtype's tolerance (f32: atol 2e-5, the
    order of the softmax sums; bf16: rtol/atol 2e-2, one last-bit flip
    of the rounded output), both updated caches bit-equal."""
    jdt, tdt, _ = DTYPES[dtype]
    tol = dict(atol=2e-5, rtol=0) if dtype == "f32" else \
        dict(atol=2e-2, rtol=2e-2)
    rng = np.random.default_rng(cur_len)
    b, h, kh, dh, smax = 2, 8, 2, 16, 48
    arrays = [jnp.asarray(rng.normal(size=shp), jdt) for shp in (
        (b, h, dh), (b, smax, kh, dh), (b, smax, kh, dh), (b, kh, dh),
        (b, kh, dh))]
    j_out, j_k, j_v = jl.attention_decode(*arrays, jnp.int32(cur_len))
    q, kc, vc, kn, vn = (_torch(a, tdt) for a in arrays)
    t_out, t_k, t_v = tl.attention_decode(q, kc, vc, kn, vn, cur_len)
    assert t_k is kc and t_v is vc                      # updated in place
    assert t_out.dtype == tdt
    np.testing.assert_allclose(t_out.float().numpy(), _np(j_out), **tol)
    np.testing.assert_array_equal(t_k.float().numpy(), _np(j_k))
    np.testing.assert_array_equal(t_v.float().numpy(), _np(j_v))


def test_rope_and_rms_norm_match_jax_in_bf16():
    """Two of the rounding points the bf16 path depends on, bit for bit."""
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(2, 9, 4, 16)), jnp.bfloat16)
    scale = jnp.asarray(rng.normal(size=(16,)) * 0.1, jnp.bfloat16)
    pos = jnp.arange(9, dtype=jnp.int32) + 1000
    np.testing.assert_array_equal(
        tl.apply_rope(_torch(x, torch.bfloat16), torch.from_numpy(
            np.array(pos)), 1e4).float().numpy(),
        _np(jl.apply_rope(x, pos, 1e4)))
    np.testing.assert_array_equal(
        tl.rms_norm(_torch(x, torch.bfloat16),
                    _torch(scale, torch.bfloat16)).float().numpy(),
        _np(jl.rms_norm(x, scale)))


def test_serving_entry_points_refuse_what_they_do_not_port():
    """A slot outside the cache is refused, with or without a window;
    ``window=`` takes JAX's rolling branch (a 4-slot window over a
    4-slot cache at cur_len 6: slot 2 written, all 4 read), and the
    param counts equal the JAX configs' for every LM arch."""
    cfg = glm4_9b.smoke_config()
    rng = np.random.default_rng(9)
    q, kc, vc, kn, vn = (rng.normal(size=shp).astype(np.float32) for shp in (
        (1, 4, 16), (1, 4, 2, 16), (1, 4, 2, 16), (1, 2, 16), (1, 2, 16)))
    want, wk, _ = jl.attention_decode(*map(jnp.asarray, (q, kc, vc, kn, vn)),
                                      jnp.int32(6), window=4)
    got, gk, _ = tl.attention_decode(*map(torch.from_numpy,
                                          (q, kc, vc, kn, vn)), 6, window=4)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-5, rtol=0)
    np.testing.assert_array_equal(gk.numpy(), _np(wk))
    kc = torch.zeros(1, 4, 2, 16)
    for cur, window in ((4, None), (5, 8)):
        with pytest.raises(ValueError, match="outside the cache"):
            tl.attention_decode(torch.zeros(1, 4, 16), kc, kc.clone(),
                                torch.zeros(1, 2, 16), torch.zeros(1, 2, 16),
                                cur, window=window)
    assert cfg.param_count() == jax_glm4.smoke_config().param_count()
    assert glm4_9b.CONFIG.param_count() == jax_glm4.CONFIG.param_count()
    for arch in LM_ARCHS:
        for make in (lambda m: m.CONFIG, lambda m: m.smoke_config()):
            t, j = make(get_arch(arch)), make(jax_arch(arch))
            assert t.param_count() == j.param_count(), arch
            assert t.active_param_count() == j.active_param_count(), arch
