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
from repro_torch.kernels.tropical_matmul import minplus, minplus_ref
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
