"""The port's CUDA kernels against their plain versions, on the card.

Skips without a CUDA device: a CUDA kernel has no CPU mode.  Run on a
GPU machine with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``; this file imports neither JAX nor the JAX
package, so it runs where only the port is installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.edge_relax import relax_level_, relax_level_ref_
from repro_torch.kernels.embedding_bag import bag_sum, bag_sum_ref, take_fill
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.tropical_matmul import minplus, minplus_ref
from repro_torch.kernels.tropical_matmul import ops as mp_ops
from torchsupport import plan_like_level, t

MINPLUS_SHAPES = [(1, 1, 1), (4, 7, 9), (8, 128, 128), (64, 130, 257),
                  (128, 128, 384), (33, 65, 5), (32, 1000, 777)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", MINPLUS_SHAPES)
def test_minplus_kernel_on_card(cuda_device, m, k, n):
    rng = np.random.default_rng(m + k + n)
    a = rng.uniform(0, 10, (m, k)).astype(np.float32)
    b = rng.uniform(0, 10, (k, n)).astype(np.float32)
    a[0, 0] = np.inf
    b[rng.random((k, n)) < 0.1] = np.inf
    before = minplus.launches
    got = minplus(t(a).to(cuda_device), t(b).to(cuda_device)).cpu()
    assert minplus.launches == before + 1
    np.testing.assert_array_equal(got.numpy(), minplus_ref(t(a), t(b)).numpy())


@pytest.mark.cuda
def test_minplus_kernel_strided_rows_on_card(cuda_device):
    rng = np.random.default_rng(2)
    wide = t(rng.uniform(0, 10, (40, 300)).astype(np.float32))
    b = t(rng.uniform(0, 10, (250, 129)).astype(np.float32))
    got = minplus(wide.to(cuda_device)[:, 30:280], b.to(cuda_device))
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  minplus_ref(wide[:, 30:280], b).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,pad,n_k", [
    (32, 3, 300, 0, 8),          # K smaller than the split count
    (32, 40, 300, 0, 5),         # 2 K tiles asked for 5 chunks
    (32, 1001, 777, 0, None),    # K and N not multiples of their tiles
    (32, 1001, 777, 0, 7),       # a short last chunk
    (1, 640, 1000, 0, None), (1, 640, 1000, 0, 3),      # M = 1
    (33, 700, 260, 0, None), (33, 700, 260, 0, 4),      # M = 33
    (32, 999, 513, 13, None), (32, 999, 513, 1, 6),     # strided a
    (32, 1024, 256, 0, None),    # every width 16 bytes
    (5, 2000, 130, 2, 3)])
def test_minplus_kernel_edge_cases_on_card(cuda_device, m, k, n, pad, n_k):
    """The split-K kernel bit-equal to the plain version at the edges of
    its tiles and splits, with an all-+inf row of a, all-+inf columns of
    b, and a row of a that is +inf but for its last entry (in the last,
    ragged K tile); ``n_k`` forces a split."""
    rng = np.random.default_rng(m * 7 + k + n)
    wide = rng.uniform(0, 100, (m, k + pad)).astype(np.float32)
    b = rng.uniform(0, 1000, (k, n)).astype(np.float32)
    wide[rng.random(wide.shape) < 0.3] = np.inf
    b[rng.random(b.shape) < 0.05] = np.inf
    wide[0, :k] = np.inf
    wide[0, k - 1] = 1.0
    inf_rows = [m - 1] if m > 1 else []
    wide[inf_rows] = np.inf
    b[:, n // 3] = np.inf
    b[:, -1] = np.inf
    a = t(wide).to(cuda_device)[:, :k]
    bd = t(b).to(cuda_device)
    before = minplus.launches
    got = minplus(a, bd) if n_k is None else mp_ops._launch(a, bd, n_k=n_k)
    assert minplus.launches == before + 1
    want = minplus_ref(t(wide)[:, :k], t(b))
    assert torch.equal(got.cpu(), want)
    assert torch.isinf(got[inf_rows]).all() and torch.isinf(got[:, -1]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kh,dh,s,kv_len,n_split", [
    (2, 32, 2, 128, 2048, 1, None),          # kv_len 1
    (2, 32, 2, 128, 2048, 1, 4),
    (2, 32, 2, 128, 2048, 64 * 7 + 17, None),  # ends mid-tile, mid-ring
    (2, 32, 2, 128, 2048, 64 * 3 + 1, 1),      # one split: mid-ring
    (2, 32, 2, 128, 1000, 999, None),        # kv_len < S, S no tile multiple
    (2, 32, 2, 128, 2048, 640, 3),           # last split short (4+4+2 tiles)
    (1, 16, 1, 128, 4096, 4096, 5),          # 13 + 13 + 13 + 13 + 12 tiles
    (3, 48, 3, 64, 1500, 1300, 7),
    (1, 4, 4, 64, 640, 300, 2), (2, 16, 2, 64, 700, 650, None),
    (2, 32, 2, 32, 2048, 640, 3),            # dh 32: 64-column boxes
    (3, 15, 3, 32, 1000, 999, 4),            # dh 32, one head: 32 columns
    (2, 8, 2, 16, 1000, 700, 3),             # dh 16, two heads: 32 columns
    (1, 8, 1, 16, 2048, 2000, 5)])           # dh 16, one head: 16 columns
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_ring_edge_cases_on_card(cuda_device, b, h, kh, dh, s,
                                              kv_len, n_split, q_dtype):
    """The tensor-core form's TMA ring at its edges (tiles cut by the end
    of the tensor map, short last splits, one and two KV heads a block),
    with f32 q (three q terms) and bf16 q (one), atol 1e-4 against the
    plain version; ``n_split`` forces the split count."""
    rng = np.random.default_rng(b * h + s + kv_len)
    q = t(rng.normal(size=(b, h, dh)).astype(np.float32)).to(q_dtype)
    kc = t(rng.normal(size=(b, s, kh, dh)).astype(np.float32)).bfloat16()
    vc = t(rng.normal(size=(b, s, kh, dh)).astype(np.float32)).bfloat16()
    args = [x.to(cuda_device) for x in (q, kc, vc)]
    before = flash_decode.launches
    got = (flash_decode(*args, kv_len) if n_split is None
           else fd_ops._launch(*args, kv_len, n_split=n_split))
    assert flash_decode.launches == before + 1
    want = flash_decode_ref(q, kc, vc, kv_len)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4,
                               rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("s,n,m,k", [(1, 10, 4, 1), (33, 500, 96, 16),
                                     (70, 2000, 300, 40),
                                     (32, 4000, 2240, 16)])
def test_relax_level_kernel_on_card(cuda_device, s, n, m, k):
    dist, dst, src, w, valid = plan_like_level(s, n, m, k, seed=m)
    args = [t(x).to(cuda_device) for x in (dst, src, w, valid)]
    before = relax_level_.launches
    got = relax_level_(t(dist).to(cuda_device), *args).cpu()
    assert relax_level_.launches == before + 1
    want = relax_level_ref_(t(dist), t(dst), t(src), t(w), t(valid))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kh,dh,s,kv_len", [
    (1, 4, 4, 16, 64, 1), (2, 8, 2, 16, 96, 17), (2, 8, 8, 32, 128, 128),
    (1, 16, 4, 64, 256, 200), (3, 32, 2, 128, 1000, 999),
    (2, 32, 2, 128, 4096, 4096), (1, 12, 3, 256, 77, 300),
    (2, 32, 1, 64, 300, 250), (5, 6, 6, 128, 131, 65),
    (2, 24, 2, 96, 200, 150), (1, 32, 1, 48, 150, 149),
    (2, 6, 3, 16, 300, 257), (1, 10, 5, 32, 500, 450)])
@pytest.mark.parametrize("dtype,q_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
def test_flash_decode_kernel_on_card(cuda_device, b, h, kh, dh, s, kv_len,
                                     dtype, q_dtype):
    """The split-KV kernel against its plain version; atol 1e-4 on the f32
    output (both keep scores and p in f32; only the order of the softmax
    sums differs).  bf16 caches with G <= 16 and dh in {16, 32, 64, 128}
    take the tensor-core form (an f32 q as three bf16 terms), the rest
    SIMT.  The last two shapes give the SIMT form more than one
    accumulator a thread with dh/4 not dividing its 256 threads."""
    rng = np.random.default_rng(b * h + s)
    q = t(rng.normal(size=(b, h, dh)).astype(np.float32)).to(q_dtype)
    kc = t(rng.normal(size=(b, s, kh, dh)).astype(np.float32)).to(dtype)
    vc = t(rng.normal(size=(b, s, kh, dh)).astype(np.float32)).to(dtype)
    before = flash_decode.launches
    got = flash_decode(q.to(cuda_device), kc.to(cuda_device),
                       vc.to(cuda_device), kv_len).cpu()
    assert flash_decode.launches == before + 1
    want = flash_decode_ref(q, kc, vc, kv_len)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("v,d,b,k", [
    (10, 8, 3, 2), (50, 24, 9, 6), (100, 128, 32, 4), (7, 64, 17, 1),
    (1000, 64, 4096, 1), (33, 5, 40, 3), (300, 4096, 5, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bag_sum_kernel_on_card(cuda_device, v, d, b, k, dtype):
    """Bit-equal to the plain version: both round each product to the
    table's dtype and sum over k in order in f32.  The ids include
    ``jnp.take``'s out-of-range cases: -1 and -V wrap, V and -V-1 give
    zero rows."""
    rng = np.random.default_rng(v + d + b)
    tab = t(rng.normal(size=(v, d)).astype(np.float32)).to(dtype)
    ids = rng.integers(0, v, (b, k)).astype(np.int32)
    ids.flat[:4] = [-1, v, -v, -v - 1][:ids.size]
    mask = t(rng.random((b, k)) < 0.7)
    before = bag_sum.launches
    got = bag_sum(tab.to(cuda_device), t(ids).to(cuda_device),
                  mask.to(cuda_device)).cpu()
    assert bag_sum.launches == before + 1
    assert got.dtype == dtype
    want = bag_sum_ref(take_fill(tab, t(ids)), mask)
    np.testing.assert_array_equal(got.float().numpy(), want.float().numpy())


@pytest.mark.cuda
def test_wrappers_reject_bad_cuda_inputs(cuda_device):
    a = torch.ones(4, 5, device=cuda_device)
    with pytest.raises(ValueError):
        minplus(a, torch.ones(5, 3))                      # mixed devices
    with pytest.raises(ValueError):
        minplus(a.double(), torch.ones(5, 3, dtype=torch.float64,
                                       device=cuda_device))
    with pytest.raises(ValueError):
        minplus(a, torch.ones(3, 5, device=cuda_device).t())  # b strided
    dist, dst, src, w, valid = plan_like_level(2, 10, 4, 1, seed=0)
    args = [t(x).to(cuda_device) for x in (dist, dst, src, w, valid)]
    args[2] = args[2].long()
    with pytest.raises(ValueError, match="int32"):
        relax_level_(*args)
