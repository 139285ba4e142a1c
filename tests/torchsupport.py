"""Shared inputs of the port's kernel tests (CPU and on the card)."""
import numpy as np
import torch


def t(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over a contiguous copy of ``a``."""
    return torch.from_numpy(np.ascontiguousarray(a))


def plan_like_level(s, n, m, k, seed):
    """A level built the way a plan level is: gathered nodes and written
    nodes disjoint, split rows of one destination, sentinel padding slots
    (column ``n``, +inf weight), trailing invalid padding rows, and one
    invalid row whose zero-weight edges would win."""
    rng = np.random.default_rng(seed)
    half = n // 2
    n_valid = m - max(1, m // 8)
    dst = np.full(m, n, np.int32)
    dst[:n_valid] = np.sort(rng.choice(np.arange(half, n),
                                       size=n_valid))   # repeats = splits
    src = np.full((m, k), n, np.int32)
    w = np.full((m, k), np.inf, np.float32)
    real = np.arange(k)[None, :] < rng.integers(1, k + 1, n_valid)[:, None]
    src[:n_valid][real] = rng.integers(0, half, int(real.sum()))
    w[:n_valid][real] = rng.integers(1, 11, int(real.sum()))
    valid = np.arange(m) < n_valid
    valid[0] = False
    w[0, 0], src[0, 0] = 0.0, 0
    dist = rng.integers(0, 60, (s, n + 1)).astype(np.float32)
    dist[rng.random((s, n + 1)) < 0.3] = np.inf
    dist[:, n] = np.inf                   # the scrap column
    return dist, dst, src, w, valid
