"""The port's fused bag-sum module against the JAX package's.

On the CPU the port's ``bag_sum`` runs its plain version (``take_fill``
then ``bag_sum_ref``); it is held against the JAX ``bag_sum`` with the
Pallas kernel in interpret mode, on the same numpy inputs.  The CUDA
kernel runs only on a card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag.ops import bag_sum as jax_bag_sum
from repro_torch.kernels.embedding_bag import bag_sum, take_fill
from torchsupport import t as _t

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _table(rng, v, d, jdt):
    jtab = jnp.asarray(rng.normal(size=(v, d)), jdt)
    tab = torch.from_numpy(np.array(jtab.astype(jnp.float32)))
    return jtab, tab


@pytest.mark.parametrize("v,d,b,k", [
    (10, 8, 3, 2), (50, 24, 9, 6), (100, 128, 32, 4), (7, 64, 17, 1),
])
@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["f32", "bf16"])
def test_bag_sum_matches_jax(v, d, b, k, jdt, tdt):
    """rtol 1e-6 for f32 tables and 2e-2 for bf16 (the sums run in
    another order and precision), as ``tests/test_kernels.py`` holds the
    JAX kernel to its own reference."""
    rng = np.random.default_rng(v * 100 + d)
    jtab, tab = _table(rng, v, d, jdt)
    ids = rng.integers(0, v, (b, k)).astype(np.int32)
    mask = rng.random((b, k)) < 0.7
    got = bag_sum(tab.to(tdt), _t(ids), _t(mask))
    assert got.dtype == tdt and got.shape == (b, d)
    want = jax_bag_sum(jtab, jnp.asarray(ids), jnp.asarray(mask),
                       use_pallas=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2 if tdt == torch.bfloat16 else 1e-6)


def test_bag_sum_out_of_range_ids_follow_jnp_take():
    """``jnp.take(..., fill_value=0)``: -1 and -V wrap to rows V-1 and 0;
    V and -V-1 give zero rows.  f32 sums of one row are exact."""
    rng = np.random.default_rng(3)
    v = 6
    jtab, tab = _table(rng, v, 16, jnp.float32)
    ids = np.array([[-1, 4], [v, 2], [-v, v + 7], [-v - 1, -2]], np.int32)
    mask = np.array([[1, 0], [1, 1], [1, 1], [1, 0]], np.float32)
    got = bag_sum(tab, _t(ids), _t(mask)).numpy()
    want = np.asarray(jax_bag_sum(jtab, jnp.asarray(ids), jnp.asarray(mask),
                                  use_pallas=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], tab[v - 1].numpy())
    np.testing.assert_array_equal(got[1], tab[2].numpy())
    np.testing.assert_array_equal(got[2], tab[0].numpy())
    np.testing.assert_array_equal(got[3], np.zeros(16, np.float32))
    np.testing.assert_array_equal(
        take_fill(tab, _t(ids)).numpy(),
        np.asarray(jnp.take(jtab, jnp.asarray(ids), axis=0, fill_value=0)))


def test_bag_sum_cpu_path_and_errors():
    tab = torch.ones(5, 8)
    ids = torch.zeros(3, 2, dtype=torch.int32)
    before = bag_sum.launches
    np.testing.assert_array_equal(
        bag_sum(tab, ids, torch.ones(3, 2)).numpy(), np.full((3, 8), 2.0))
    assert bag_sum.launches == before
    with pytest.raises(ValueError, match=r"\[B, K\]"):
        bag_sum(tab, ids, torch.ones(3, 3))
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        bag_sum(torch.empty(5, 8, **meta),
                torch.empty(3, 2, dtype=torch.int32, **meta),
                torch.empty(3, 2, **meta))
