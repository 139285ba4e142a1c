"""Dense helpers shared by the port's models."""
from typing import Callable, List, Sequence

import torch


def dense_init(generator: torch.Generator, shape: Sequence[int],
               in_axis: int = 0, dtype: torch.dtype = torch.float32,
               device=None) -> torch.Tensor:
    """Normal x fan_in^-0.5, drawn in f32 from ``generator`` on
    ``device`` and cast to ``dtype`` (the JAX package's ``dense_init``;
    the numbers differ, the law does not)."""
    scale = (1.0 / max(shape[in_axis], 1)) ** 0.5
    w = torch.randn(tuple(shape), generator=generator, device=device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def mlp(x: torch.Tensor, weights, act: Callable = torch.relu
        ) -> torch.Tensor:
    """weights: list of (W, b); activation between layers, none after last."""
    for i, (w, b) in enumerate(weights):
        x = x @ w + b
        if i < len(weights) - 1:
            x = act(x)
    return x


def mlp_init(generator: torch.Generator, dims: Sequence[int],
             dtype: torch.dtype = torch.float32, device=None) -> List[list]:
    return [[dense_init(generator, (dims[i], dims[i + 1]), dtype=dtype,
                        device=device),
             torch.zeros(dims[i + 1], dtype=dtype, device=device)]
            for i in range(len(dims) - 1)]
