"""The keyed draw of a model's initial state, block by block.

A leaf's values are a function of ``(seed, the leaf's path in its tree,
the element's position)``, never of the draws before it, so a rank
draws its own blocks of a sharded leaf without the rest, and the blocks
of every rank side by side are the leaf drawn whole, bit for bit.

A leaf is cut into tiles, a grid that depends on its shape and its
logical axes only, never on the mesh (:func:`tile_shape`).  Each tile
is drawn whole in f32 from a generator of its own, seeded from
``(seed, path, tile index)`` (:func:`tile_seed`) on the leaf's device,
scaled, and copied (cast to the leaf's dtype) where it meets the block
(``shardlib.block_slices`` under the leaf's ``NamedSharding``; the
whole leaf without one).  A rank draws only the tiles its block meets,
one at a time, so it never holds more than its blocks and one tile.
CUDA's Philox maps elements to counters by the launch's grid, which
depends on the tensor's size, so a tile is never drawn in part: a mesh
whose split does not line up with the grid (a ``(1, 3)`` mesh, say)
draws the tiles it meets partly, whole, and keeps its part.

The laws are the JAX package's: matrices normal x fan_in^-0.5
(:func:`fan_in_scale`), the rm2 tables uniform in +-V^-0.5.  Zeros (the
norm scales, the biases, AdamW's m and v, the KV caches) are made at
block size and nothing is drawn for them.  ``draw=False`` leaves a
block uninitialised (``torch.empty``), for a restore to fill or for the
dry run's fake tensors.
"""
from __future__ import annotations

import hashlib
import itertools
import math
from typing import Optional, Sequence, Tuple

import torch

from .. import shardlib as sl

#: The most bytes a tile holds in f32.
TILE_BYTES = 32 << 20

#: The logical axis of a layer stack's cycles: its tiles are one cycle.
STACK = "layer_stack"


def _smallest_factor(n: int) -> int:
    f = 2
    while f * f <= n:
        if n % f == 0:
            return f
        f += 1
    return n


def tile_shape(shape: Sequence[int], axes: Sequence[Optional[str]]
               ) -> Tuple[int, ...]:
    """The tile of a leaf of ``shape`` whose dims carry the logical
    ``axes``: one cycle along a ``layer_stack`` dim; then, while the
    tile holds more than TILE_BYTES in f32, the named dim with the
    longest tile is divided by its smallest prime factor (the first such
    dim on a tie), and the unnamed dims likewise once no named dim can
    be divided.  The tile's extents divide the leaf's."""
    tile = [1 if a == STACK else int(n) for n, a in zip(shape, axes)]
    named = [d for d, a in enumerate(axes) if a is not None and a != STACK]
    other = [d for d, a in enumerate(axes) if a is None]
    while 4 * math.prod(tile) > TILE_BYTES:
        for dims in (named, other):
            cut = [d for d in dims if tile[d] > 1]
            if cut:
                d = max(cut, key=lambda d: (tile[d], -d))
                tile[d] //= _smallest_factor(tile[d])
                break
        else:
            break
    return tuple(tile)


def tile_seed(seed: int, path: str, index: Sequence[int]) -> int:
    """The 63-bit seed of tile ``index`` of the leaf at ``path``."""
    key = f"{seed}/{path}/{','.join(str(i) for i in index)}".encode()
    return int.from_bytes(hashlib.blake2b(key, digest_size=8).digest(),
                          "little") >> 1


def fan_in_scale(shape: Sequence[int], in_axis: int = 0) -> float:
    """The JAX ``dense_init`` scale, fan_in^-0.5 (fan-in: ``shape[in_axis]``)."""
    return (1.0 / max(int(shape[in_axis]), 1)) ** 0.5


def draw_tile(path: str, index: Tuple[int, ...], tile: Tuple[int, ...],
              law: str, scale: float, device: torch.device,
              seed: int) -> torch.Tensor:
    """Tile ``index`` of the leaf at ``path``, whole, in f32 on
    ``device``: normal x ``scale``, or uniform in +-``scale``."""
    gen = torch.Generator(device="cpu" if device.type == "meta" else device)
    gen.manual_seed(tile_seed(seed, path, index))
    if law == "normal":
        return torch.randn(tile, generator=gen, device=device,
                           dtype=torch.float32).mul_(scale)
    if law == "uniform":
        return torch.empty(tile, dtype=torch.float32, device=device
                           ).uniform_(-scale, scale, generator=gen)
    raise ValueError(f"{path}: no law {law!r} (normal, uniform or zeros)")


def block_slices(shape: Sequence[int], sharding) -> Tuple[slice, ...]:
    """This rank's slices of a leaf of ``shape`` under ``sharding`` (a
    ``NamedSharding``; None: the whole leaf)."""
    if sharding is None:
        return tuple(slice(0, int(n)) for n in shape)
    return sl.block_slices(shape, sharding.spec, sharding.mesh)


def keyed(path: str, shape: Sequence[int], axes: Sequence[Optional[str]],
          law: str = "zeros", scale: float = 0.0,
          dtype: torch.dtype = torch.float32, device=None, sharding=None,
          seed: int = 0, draw: bool = True) -> torch.Tensor:
    """This rank's block (under ``sharding``; the whole leaf without
    one) of the leaf at ``path`` of ``shape`` with logical ``axes``,
    drawn by ``law`` ("normal" x ``scale``, "uniform" in +-``scale``, or
    "zeros") in ``dtype`` on ``device`` (the module's docstring)."""
    device = torch.device(device) if device is not None else None
    shape = tuple(int(n) for n in shape)
    if len(axes) != len(shape):
        raise ValueError(f"{path}: axes {tuple(axes)} for shape {shape}")
    blk = block_slices(shape, sharding)
    size = tuple(s.stop - s.start for s in blk)
    if not draw:
        return torch.empty(size, dtype=dtype, device=device)
    if law == "zeros":
        return torch.zeros(size, dtype=dtype, device=device)
    out = torch.empty(size, dtype=dtype, device=device)
    tile = tile_shape(shape, axes)
    met = [range(s.start // t, -(-s.stop // t)) for s, t in zip(blk, tile)]
    for index in itertools.product(*met):
        src, dst = [], []
        for s, t, i in zip(blk, tile, index):
            lo, hi = max(s.start, i * t), min(s.stop, (i + 1) * t)
            src.append(slice(lo - i * t, hi - i * t))
            dst.append(slice(lo - s.start, hi - s.start))
        drawn = draw_tile(path, index, tile, law, scale, out.device, seed)
        out[tuple(dst)].copy_(drawn[tuple(src)])
        del drawn
    return out
