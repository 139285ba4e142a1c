"""Preferential-attachment digraph, each new node attached to
``m_per_node`` earlier ones, each arc oriented at random: the web/social
stand-in (Meme, UKWeb in the paper).

A frozen copy of ``repro_torch.core.graph.power_law_digraph`` (the same
draws in the same order), with integer weights uniform in
``[weight_min, weight_max]`` drawn from ``rng`` after the structure."""
import numpy as np


def edges(params: dict, rng: np.random.Generator):
    """``(n, src, dst, w)``: int64 arc ends and float64 weights."""
    n = int(params["n"])
    m = int(params["m_per_node"])
    src_l, dst_l = [], []
    targets = np.arange(min(m, n), dtype=np.int64)
    repeated = list(targets)
    for v in range(len(targets), n):
        picks = rng.choice(len(repeated), size=min(m, len(repeated)),
                           replace=False)
        for p in picks:
            u = repeated[p]
            if rng.random() < 0.5:
                src_l.append(v)
                dst_l.append(u)
            else:
                src_l.append(u)
                dst_l.append(v)
            repeated.append(u)
        repeated.extend([v] * m)
    src = np.asarray(src_l, dtype=np.int64)
    dst = np.asarray(dst_l, dtype=np.int64)
    w = rng.integers(int(params["weight_min"]), int(params["weight_max"]) + 1,
                     size=src.shape[0]).astype(np.float64)
    return n, src, dst, w
