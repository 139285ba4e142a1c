"""Dense helpers shared by the port's models."""
from typing import Callable, List, Optional, Sequence

import torch

from . import init


def dense_init(generator: Optional[torch.Generator], shape: Sequence[int],
               in_axis: int = 0, dtype: torch.dtype = torch.float32,
               device=None, *, path: str = "", axes=None, sharding=None,
               draw: bool = True) -> torch.Tensor:
    """Normal x fan_in^-0.5 in ``dtype`` on ``device`` (the JAX
    package's ``dense_init``; the numbers differ, the law does not).
    With a ``generator``: drawn whole in f32 from it and cast.  Without
    one: the keyed draw of the leaf at ``path`` (``models/init.py``),
    tiled by its logical ``axes`` (default: none named), this rank's
    block under ``sharding`` (None: the whole leaf)."""
    scale = init.fan_in_scale(shape, in_axis)
    if generator is None:
        return init.keyed(path, shape, axes or (None,) * len(shape),
                          "normal", scale, dtype, device, sharding,
                          draw=draw)
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


def mlp_init(generator: Optional[torch.Generator], dims: Sequence[int],
             dtype: torch.dtype = torch.float32, device=None, *,
             path: str = "", shardings=None, draw: bool = True
             ) -> List[list]:
    """``[[W, b], ...]`` between ``dims``: W by :func:`dense_init`, b
    zeros.  Without a ``generator`` each leaf is keyed by its path under
    ``path`` (``{path}/{i}/0``, ``{path}/{i}/1``) and is this rank's
    block under its entry of ``shardings`` (the same list of pairs;
    None: whole leaves)."""
    out = []
    for i in range(len(dims) - 1):
        shape = (dims[i], dims[i + 1])
        if generator is not None:
            out.append([dense_init(generator, shape, dtype=dtype,
                                   device=device),
                        torch.zeros(dims[i + 1], dtype=dtype, device=device)])
            continue
        w_sh, b_sh = shardings[i] if shardings is not None else (None, None)
        out.append([dense_init(None, shape, dtype=dtype, device=device,
                               path=f"{path}/{i}/0", sharding=w_sh,
                               draw=draw),
                    init.keyed(f"{path}/{i}/1", shape[1:], (None,),
                               dtype=dtype, device=device, sharding=b_sh,
                               draw=draw)])
    return out
