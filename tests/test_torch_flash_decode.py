"""The port's flash-decoding module against the JAX package's.

On the CPU the port's ``flash_decode`` runs its plain version
(``flash_decode_ref``); it is held against the JAX Pallas kernel (in
interpret mode, as ``tests/test_kernels.py`` runs it) and the JAX
``flash_decode_ref`` on the same numpy inputs.  The CUDA kernel itself
runs only on a card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode.ops import flash_decode as jax_flash_decode
from repro.kernels.flash_decode.ops import flash_decode_ref as jax_ref
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref
from torchsupport import t as _t

# (b, h, kh, dh, smax, kv_len, block_k); the last two at gemma3's dh 256,
# narrow (G 2 and G 4)
SHAPES = [(1, 4, 4, 16, 64, 1, 32), (2, 8, 2, 16, 96, 17, 32),
          (2, 8, 8, 32, 128, 128, 64), (1, 16, 4, 64, 256, 200, 128),
          (1, 4, 2, 256, 96, 77, 32), (2, 8, 2, 256, 128, 128, 64)]


def _inputs(b, h, kh, dh, smax, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, dh)).astype(np.float32)
    kc = rng.normal(size=(b, smax, kh, dh)).astype(np.float32)
    vc = rng.normal(size=(b, smax, kh, dh)).astype(np.float32)
    return q, kc, vc


@pytest.mark.parametrize("b,h,kh,dh,smax,kv_len,blk", SHAPES)
def test_flash_decode_f32_cache_matches_jax(b, h, kh, dh, smax, kv_len, blk):
    """f32 caches: atol 2e-5 against both JAX versions (the Pallas
    kernel's running softmax sums in another order)."""
    q, kc, vc = _inputs(b, h, kh, dh, smax, seed=smax + kv_len)
    got = flash_decode(_t(q), _t(kc), _t(vc), kv_len).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc)
    np.testing.assert_allclose(got, np.asarray(jax_ref(jq, jk, jv, kv_len)),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(got, np.asarray(jax_flash_decode(
        jq, jk, jv, kv_len, block_k=blk, use_pallas=True)), atol=2e-5,
        rtol=0)


@pytest.mark.parametrize("b,h,kh,dh,smax,kv_len,blk", SHAPES)
def test_flash_decode_bf16_cache_matches_jax(b, h, kh, dh, smax, kv_len,
                                             blk):
    """bf16 caches: rtol/atol 2e-2 against the Pallas kernel, which rounds
    p to bf16 before the PV product (the port keeps it f32, as
    ``attention_decode`` does); atol 2e-5 against the JAX ``ref``, which
    keeps it f32 too."""
    q, kc, vc = _inputs(b, h, kh, dh, smax, seed=smax * 3 + kv_len)
    jk = jnp.asarray(kc, jnp.bfloat16)
    jv = jnp.asarray(vc, jnp.bfloat16)
    kb = torch.from_numpy(np.array(jk.astype(jnp.float32))).bfloat16()
    vb = torch.from_numpy(np.array(jv.astype(jnp.float32))).bfloat16()
    got = flash_decode(_t(q), kb, vb, kv_len).numpy()
    jq = jnp.asarray(q)
    np.testing.assert_allclose(got, np.asarray(jax_ref(jq, jk, jv, kv_len)),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(got, np.asarray(jax_flash_decode(
        jq, jk, jv, kv_len, block_k=blk, use_pallas=True)), rtol=2e-2,
        atol=2e-2)


def test_flash_decode_bf16_q_is_scaled_in_bf16():
    """A bf16 q is scaled by dh**-0.5 rounded to bf16 and the product
    rounded to bf16, as JAX's weakly typed scalar does: the plain
    versions then agree to f32 rounding, atol 2e-6."""
    q, kc, vc = _inputs(2, 8, 2, 32, 80, seed=5)
    jq = jnp.asarray(q, jnp.bfloat16)
    qb = torch.from_numpy(np.array(jq.astype(jnp.float32))).bfloat16()
    got = flash_decode_ref(qb, _t(kc), _t(vc), 41).numpy()
    want = np.asarray(jax_ref(jq, jnp.asarray(kc), jnp.asarray(vc), 41))
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


def test_flash_decode_cpu_path_and_errors():
    q, kc, vc = _inputs(1, 4, 2, 16, 40, seed=0)
    before = flash_decode.launches
    beyond = flash_decode(_t(q), _t(kc), _t(vc), 500)   # kv_len > S: all
    np.testing.assert_array_equal(beyond.numpy(), flash_decode(
        _t(q), _t(kc), _t(vc), 40).numpy())
    assert flash_decode.launches == before
    with pytest.raises(ValueError, match="kv_len"):
        flash_decode(_t(q), _t(kc), _t(vc), 0)
    with pytest.raises(ValueError, match="does not fit"):
        flash_decode(_t(q[:, :3]), _t(kc), _t(vc), 4)
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode(torch.empty(1, 4, 16, **meta),
                     torch.empty(1, 8, 2, 16, **meta),
                     torch.empty(1, 8, 2, 16, **meta), 3)
