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


def plan_like_sweep(s, n, n_levels, m, k, seed, empty=()):
    """Bucketed levels built the way a sweep's are: node bands of rising
    rank, level ``l`` reading bands ``0..l`` and writing band ``l+1`` (so
    each level reads what the one before it wrote, and its own reads and
    writes are disjoint), split rows of one destination, sentinel padding
    slots (node ``n``), trailing invalid rows, and an invalid row whose
    zero-weight edge would win.  Levels in ``empty`` have no valid row.
    Returns (dist [n+1, s] node-major, [(dst, src_idx, w, row_valid)])."""
    rng = np.random.default_rng(seed)
    bands = np.linspace(0, n, n_levels + 2).astype(np.int64)
    levels = []
    for lvl in range(n_levels):
        lo, hi = bands[lvl + 1], bands[lvl + 2]
        n_valid = 0 if lvl in empty else m - max(1, m // 8)
        dst = np.full(m, n, np.int32)
        dst[:n_valid] = np.sort(rng.integers(lo, hi, n_valid))
        src = np.full((m, k), n, np.int32)
        w = np.full((m, k), np.inf, np.float32)
        real = np.arange(k)[None, :] \
            < rng.integers(1, k + 1, n_valid)[:, None]
        src[:n_valid][real] = rng.integers(0, lo, int(real.sum()))
        w[:n_valid][real] = rng.integers(1, 11, int(real.sum()))
        valid = np.arange(m) < n_valid
        if n_valid:
            valid[0] = False
            w[0, 0], src[0, 0] = 0.0, 0
        levels.append((dst, src, w, valid))
    dist = rng.integers(0, 60, (n + 1, s)).astype(np.float32)
    dist[rng.random((n + 1, s)) < 0.3] = np.inf
    dist[n] = np.inf                      # the sentinel node
    return dist, levels


def relax_levels_np(dist, levels):
    """The JAX level body on node-major numpy labels, level by level:
    ``dist[dst] = min(dist[dst], min_k dist[src_idx] + w)`` on valid
    rows, split rows merged by min."""
    out = dist.copy()
    for dst, src, w, valid in levels:
        cand = (out[src] + w[:, :, None]).min(axis=1)         # [M, S]
        cand[~valid] = np.inf
        np.minimum.at(out, dst, cand)
    return out
