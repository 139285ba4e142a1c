"""4-connected grid, undirected: the road network stand-in (USRN in the
paper is undirected and weighted).

The structure and arc order are a frozen copy of
``repro_torch.core.graph.grid_road_graph``; each road (grid edge) gets
one integer weight, uniform in ``[weight_min, weight_max]`` and drawn
from ``rng``, which both of its arcs carry."""
import numpy as np


def edges(params: dict, rng: np.random.Generator):
    """``(n, src, dst, w)``: int64 arc ends and float64 weights, ``w``
    the same on ``u -> v`` and ``v -> u``."""
    side = int(params["side"])
    n = side * side
    idx = np.arange(n, dtype=np.int64).reshape(side, side)
    right_s, right_d = idx[:, :-1].ravel(), idx[:, 1:].ravel()
    down_s, down_d = idx[:-1, :].ravel(), idx[1:, :].ravel()
    src = np.concatenate([right_s, right_d, down_s, down_d])
    dst = np.concatenate([right_d, right_s, down_d, down_s])
    lo, hi = int(params["weight_min"]), int(params["weight_max"]) + 1
    w_right = rng.integers(lo, hi, size=right_s.shape[0])
    w_down = rng.integers(lo, hi, size=down_s.shape[0])
    w = np.concatenate([w_right, w_right, w_down, w_down])
    return n, src, dst, w.astype(np.float64)
