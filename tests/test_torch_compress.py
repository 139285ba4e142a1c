"""The port's gradient compression (``repro_torch.optim.compress``)
against the JAX package's ``optim/compress.py``, on the same numpy
inputs.

The port takes the rounding noise as an array where JAX draws it from a
key, so each parity test feeds the port JAX's own draws
(``jax.random.uniform(key, shape)``, the draw ``quantize_int8`` makes).
Tolerances: none where the operations are the same f32 operations in
the same order (``q``, ``scale``, the dequantized values, top-k's values,
indices and residual, the world-size-1 means: bit for bit); the error
feedback's conservation and the int8 mean's error bound are the JAX
tests' own (``tests/test_optim.py``, ``tests/test_distribution.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.optim import compress as jc
from repro_torch.optim import (ErrorFeedback, compressed_mean,
                               dequantize_int8, quantize_int8,
                               topk_sparsify, uniform_noise, wire_bytes)
from repro_torch.tree import leaves

KEY = jax.random.PRNGKey(0)


def _grads():
    rng = np.random.default_rng(0)
    return {"a": rng.normal(size=(32, 32)).astype(np.float32),
            "b": rng.normal(size=(7,)).astype(np.float32)}


def _jax_noise(key, shape):
    return torch.from_numpy(np.array(jax.random.uniform(key, shape)))


@pytest.mark.parametrize("seed,shape,scale", [
    (0, (128, 64), 1.0), (1, (1000,), 3e-3), (2, (3, 5, 7), 1e4),
    (3, (16,), 0.0)])
def test_quantize_int8_bit_equal_to_jax(seed, shape, scale):
    """``q`` and ``scale`` bit for bit, the dequantized values too (an
    all-zero input takes the 1e-12 floor)."""
    x = (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)
    key = jax.random.PRNGKey(seed)
    jq, js = jc.quantize_int8(jnp.asarray(x), key)
    q, s = quantize_int8(torch.from_numpy(x), _jax_noise(key, shape))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.item() == float(js)
    np.testing.assert_array_equal(dequantize_int8(q, s).numpy(),
                                  np.asarray(jc.dequantize_int8(jq, js)))


def test_quantize_int8_bounds_and_noise_shape():
    """The JAX test's bounds: within 1.5 steps, and unbiased over 32
    draws of the port's own noise."""
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(128, 64)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    q, s = quantize_int8(x, uniform_noise(x.shape, gen))
    assert (dequantize_int8(q, s) - x).abs().max() <= s * 1.5
    errs = [dequantize_int8(*quantize_int8(x, uniform_noise(x.shape, gen)))
            - x for _ in range(32)]
    assert torch.stack(errs).mean(0).abs().max() < s * 0.5
    with pytest.raises(ValueError, match="noise of shape"):
        quantize_int8(x, torch.zeros(3))


def test_topk_sparsify_equals_jax():
    """Distinct magnitudes, so the order of the kept entries is defined:
    values, indices and residual equal JAX's; k past the size keeps
    all."""
    rng = np.random.default_rng(0)
    x = (rng.permutation(256).astype(np.float32) + 1.0) * rng.choice(
        [-1.0, 1.0], 256).astype(np.float32) / 7.0
    x = x.reshape(16, 16)
    for k in (1, 32, 300):
        jv, ji, jr = jc.topk_sparsify(jnp.asarray(x), k)
        v, i, r = topk_sparsify(torch.from_numpy(x), k)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
        assert r.shape == (16, 16)


def test_error_feedback_conserves_the_signal():
    """The JAX test's invariant: sent + carried equals the sum of all
    gradients (16 steps of top-32 of 256), and the carry stays bounded."""
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(256,)).astype(np.float32))
    vals, idx, residual = topk_sparsify(x, 32)
    recon = torch.zeros_like(x)
    recon[idx] = vals
    torch.testing.assert_close(recon + residual, x, rtol=0, atol=1e-6)
    carried = ErrorFeedback.init({"x": x})
    assert carried["x"].dtype == torch.float32 and not carried["x"].any()
    sent = torch.zeros_like(x)
    for _ in range(16):
        g = ErrorFeedback.apply({"x": x}, carried)["x"]
        vals, idx, carried_x = topk_sparsify(g, 32)
        carried = {"x": carried_x}
        sent.index_add_(0, idx, vals)
    np.testing.assert_allclose((sent + carried["x"]).numpy(),
                               x.numpy() * 16, rtol=1e-4, atol=1e-3)
    assert carried["x"].abs().max() < 16 * x.abs().max()


def test_wire_bytes_all_schemes():
    g = {"w": torch.zeros(1000), "h": torch.zeros(10, 10,
                                                  dtype=torch.bfloat16)}
    jg = {"w": jnp.zeros((1000,), jnp.float32),
          "h": jnp.zeros((10, 10), jnp.bfloat16)}
    assert wire_bytes({"w": g["w"]}, "none") == 4000
    assert wire_bytes({"w": g["w"]}, "int8") == 1004
    assert wire_bytes({"w": g["w"]}, "topk", topk_frac=0.01) == 80
    for scheme in ("none", "int8", "topk"):
        assert wire_bytes(g, scheme) == jc.wire_bytes(jg, scheme)


def test_compressed_mean_world_one_matches_jax():
    """World size 1: ``"none"`` is the identity; ``"int8"`` within one
    quantization step of the input and bit-equal to JAX's with JAX's
    noise (one key a leaf, split in leaf order)."""
    g = _grads()
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    out = compressed_mean(tg, None, scheme="none")
    for k in g:
        assert torch.equal(out[k], tg[k]) and out[k] is not tg[k]
    jout = jc.compressed_mean({k: jnp.asarray(v) for k, v in g.items()},
                              KEY, dp_axes=(), scheme="int8")
    keys = jax.random.split(KEY, len(g))
    noise = [_jax_noise(kk, leaf.shape)
             for kk, leaf in zip(keys, leaves(tg))]
    out8 = compressed_mean(tg, noise, scheme="int8")
    for k in g:
        np.testing.assert_array_equal(out8[k].numpy(), np.asarray(jout[k]))
        err = (out8[k] - tg[k]).abs().max().item()
        assert err <= np.abs(g[k]).max() / 127.0 * 1.01
    with pytest.raises(ValueError, match="noise arrays"):
        compressed_mean(tg, noise[:1])


def test_compressed_mean_over_a_one_rank_group(tmp_path):
    """A single-process gloo group: the all-reduced mean equals
    ``group=None``'s bit for bit, under both schemes and with a
    generator's noise."""
    g = {k: torch.from_numpy(v) for k, v in _grads().items()}
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        group = dist.group.WORLD
        for scheme in ("none", "int8"):
            want = compressed_mean(g, torch.Generator().manual_seed(5),
                                   scheme=scheme)
            got = compressed_mean(g, torch.Generator().manual_seed(5),
                                  group=group, scheme=scheme)
            for k in g:
                assert torch.equal(got[k], want[k]), (scheme, k)
    finally:
        dist.destroy_process_group()
