"""Gradient compression for data-parallel means (the JAX package's
``optim/compress.py``).

Two schemes, composable with error feedback:

* int8 quantization with a per-tensor scale and stochastic rounding,
  unbiased in expectation, a quarter of the f32 bytes on the wire;
* top-k sparsification with error feedback: only the k largest
  magnitudes are exchanged, the residual is carried to the next step.

JAX draws the rounding noise from a key inside :func:`quantize_int8`;
here the caller passes the uniform [0, 1) draws (:func:`uniform_noise`
makes them from a ``torch.Generator``), so a test can feed JAX's own
draws and compare ``q`` and ``scale`` bit for bit.
:func:`compressed_mean` averages over a ``torch.distributed`` process
group, or is the world-size-1 mean (JAX's ``dp_axes=()``) without one.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..tree import leaves, map_tree, unflatten


def uniform_noise(shape, generator: Optional[torch.Generator] = None,
                  device=None) -> torch.Tensor:
    """Uniform [0, 1) f32 draws of ``shape`` from ``generator``, on its
    device unless ``device`` is given."""
    if device is None:
        device = "cpu" if generator is None else generator.device
    return torch.rand(shape, generator=generator, dtype=torch.float32,
                      device=device)


def quantize_int8(x: torch.Tensor, noise: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stochastic-rounding int8 quantization with ``noise`` (uniform
    [0, 1) f32 draws shaped like ``x``): returns (q int8, scale 0-d f32),
    ``scale = max(max|x| / 127, 1e-12)`` and ``q = clip(round(x / scale
    + (noise - 0.5)), -127, 127)``, rounding half to even, in JAX's
    order of operations."""
    if noise.shape != x.shape:
        raise ValueError(f"noise of shape {tuple(noise.shape)} for x of "
                         f"shape {tuple(x.shape)}")
    xf = x.float()
    scale = torch.clamp(xf.abs().max() / 127.0, min=1e-12)
    y = xf / scale
    q = torch.clamp(torch.round(y + (noise.float() - 0.5)), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def topk_sparsify(x: torch.Tensor, k: int):
    """Keep the k largest |x| entries: returns (values f32, flat indices,
    residual shaped like ``x``, f32, zero where a value was kept)."""
    flat = x.reshape(-1).float()
    k = min(k, flat.shape[0])
    idx = torch.topk(flat.abs(), k).indices
    residual = flat.clone()
    residual[idx] = 0.0
    return flat[idx], idx, residual.reshape(x.shape)


class ErrorFeedback:
    """Residual accumulator: ``apply(grads, residuals)`` is the gradient
    to compress, the carried residual added to it."""

    @staticmethod
    def init(params):
        return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

    @staticmethod
    def apply(grads, residuals):
        return map_tree(lambda g, r: g.float() + r, grads, residuals)


def compressed_mean(grads, noise: Union[torch.Generator, list, None] = None,
                    group=None, scheme: str = "int8"):
    """The data-parallel mean of ``grads`` (a tree) as the wire would
    carry it: each leaf int8-quantized with its own noise and
    dequantized (``scheme="int8"``), or as it is in f32 (``"none"``),
    summed over ``group`` by ``torch.distributed.all_reduce`` and divided
    by its size, then cast back to the leaf's dtype (any scheme but
    ``"int8"`` sends f32, as in JAX).  ``group=None`` is one rank, JAX's
    ``dp_axes=()``.  ``noise``: a ``torch.Generator`` to draw each leaf's
    noise from, in leaf order, or the draws themselves (a list, or a tree
    shaped like ``grads``)."""
    gs = leaves(grads)
    if scheme == "int8":
        if isinstance(noise, torch.Generator):
            noise = [uniform_noise(g.shape, noise, device=g.device)
                     for g in gs]
        else:
            noise = leaves(noise)
        if len(noise) != len(gs):
            raise ValueError(f"{len(noise)} noise arrays for {len(gs)} "
                             "leaves")
    n = 1
    if group is not None:
        import torch.distributed as dist
        n = dist.get_world_size(group)
    out = []
    for i, g in enumerate(gs):
        if scheme == "int8":
            s = dequantize_int8(*quantize_int8(g, noise[i].to(g.device)))
        else:     # a copy: all_reduce works in place
            s = g.to(torch.float32, copy=True)
        if group is not None:
            dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
        out.append((s / n).to(g.dtype))
    return unflatten(grads, out)


def wire_bytes(grads, scheme: str = "int8", topk_frac: float = 0.01) -> int:
    """Bytes a data-parallel exchange of ``grads`` puts on the wire under
    ``scheme`` (host arithmetic on shapes and dtypes)."""
    total = 0
    for g in leaves(grads):
        if scheme == "int8":
            total += g.numel() + 4
        elif scheme == "topk":
            total += max(1, int(g.numel() * topk_frac)) * 8
        else:
            total += g.numel() * g.element_size()
    return total
