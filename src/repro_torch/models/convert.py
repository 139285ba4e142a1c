"""Carry the JAX package's parameters and optimizer state across into
the port.

The functions take the JAX pytree with every leaf as a numpy array
(``jax.tree.map(np.asarray, params)``), so this module needs no JAX: an
``.npz`` or any other numpy source works the same.  bf16 leaves
(numpy's ``ml_dtypes`` bfloat16) are taken bit for bit.

Under an active mesh (``shardlib.axis_rules``), :func:`local_blocks`
hands back this rank's blocks of a tree under a cell's
``in_shardings``: converted parameters, an LM's AdamW state (m and v
as the parameters, the count whole) and its caches, each stacked
``layer_stack`` dim whole (``shardlib.gather_blocks`` joins a leaf's
blocks back).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import shardlib as sl
from ..device import resolve_device
from ..optim import OptState
from ..tree import flatten_with_paths, map_tree
from .dlrm import DLRMConfig
from .transformer import TransformerConfig, _layer_shapes


def _tensor(a, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    a = np.array(a)                      # a writable copy torch may own
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def local_blocks(tree, shardings):
    """This rank's blocks of a tree of global tensors, leaf by leaf under
    a tree of ``NamedSharding`` (a cell's ``in_shardings``); a leaf that
    is not a tensor is kept as it is."""
    return map_tree(lambda a, s: sl.local_block(a, s.spec, s.mesh)
                    if isinstance(a, torch.Tensor) else a, tree, shardings)


def transformer_params_from_numpy(tree: Dict[str, Any],
                                  cfg: TransformerConfig, device=None,
                                  dtype: Optional[torch.dtype] = None
                                  ) -> Dict[str, Any]:
    """``{"embed", "ln_f", optional "head", "layers": [per cycle position
    {name: [n_cycles, ...]}]}`` -> the port's parameters on ``device``
    (default ``cuda``) in ``dtype`` (default ``cfg.param_dtype``).  The
    layer keys are the config's: an MoE layer's ``router`` and expert
    stacks ``wg``/``wu``/``wd`` in place of the dense MLP's."""
    device = resolve_device(device)
    dt = cfg.param_dtype if dtype is None else dtype
    if len(tree["layers"]) != cfg.local_global_period:
        raise ValueError(f"{len(tree['layers'])} cycle positions, config has "
                         f"{cfg.local_global_period}")
    shapes = _layer_shapes(cfg)
    layers = []
    for pos in tree["layers"]:
        if set(pos) != set(shapes):
            raise ValueError(f"layer keys {sorted(pos)} are not the "
                             f"config's {sorted(shapes)}")
        stack = {}
        for name, a in pos.items():
            stack[name] = _tensor(a, device, dt)
            want = (cfg.n_cycles,) + shapes[name]
            if tuple(stack[name].shape) != want:
                raise ValueError(f"{name}: shape {tuple(stack[name].shape)}, "
                                 f"config wants {want}")
        layers.append(stack)
    params = {"embed": _tensor(tree["embed"], device, dt),
              "ln_f": _tensor(tree["ln_f"], device, dt), "layers": layers}
    if tuple(params["embed"].shape) != (cfg.vocab, cfg.d_model):
        raise ValueError(f"embed: shape {tuple(params['embed'].shape)}")
    if not cfg.tie_embeddings:
        params["head"] = _tensor(tree["head"], device, dt)
    return params


def dlrm_params_from_numpy(tree: Dict[str, Any], cfg: DLRMConfig,
                           device=None) -> Dict[str, Any]:
    """``{"tables": [T, V, D], "bot"/"top": [[W, b], ...]}`` -> the
    port's DLRM parameters on ``device`` (default ``cuda``)."""
    device = resolve_device(device)
    tables = _tensor(tree["tables"], device, cfg.dtype)
    want = (cfg.n_sparse, cfg.vocab_per_table, cfg.embed_dim)
    if tuple(tables.shape) != want:
        raise ValueError(f"tables: shape {tuple(tables.shape)}, config "
                         f"wants {want}")
    return {"tables": tables,
            "bot": [[_tensor(w, device, cfg.dtype),
                     _tensor(b, device, cfg.dtype)] for w, b in tree["bot"]],
            "top": [[_tensor(w, device, cfg.dtype),
                     _tensor(b, device, cfg.dtype)] for w, b in tree["top"]]}


def gnn_params_from_numpy(tree: Dict[str, Any], arch: str, cfg,
                          device=None) -> Dict[str, Any]:
    """A GNN's JAX parameter tree (``gcn-cora``, ``gin-tu``, ``schnet``
    or ``equiformer-v2`` at ``cfg``) -> the port's parameters on
    ``device`` (default ``cuda``) in ``cfg.dtype``; its paths and shapes
    are checked against the port's ``init_params(cfg)``."""
    from .gnn import MODULES
    device = resolve_device(device)
    want = [(k, tuple(p.shape)) for k, p in flatten_with_paths(
        MODULES[arch].init_params(cfg, device="cpu"))]
    have = [(k, tuple(np.shape(a))) for k, a in flatten_with_paths(tree)]
    if have != want:
        raise ValueError(f"{arch}: leaves {have} are not the config's "
                         f"{want}")
    return map_tree(lambda a: _tensor(a, device, cfg.dtype), tree)


def adamw_state_from_numpy(state, params, device=None) -> OptState:
    """A JAX ``OptState(m, v, count)`` with numpy leaves (or a dict with
    those keys) -> the port's ``OptState`` on ``device`` (default
    ``cuda``): m and v f32 shaped like ``params`` (the port's tree; its
    paths and shapes are checked), count int32."""
    device = resolve_device(device)
    get = state.get if isinstance(state, dict) else \
        (lambda k: getattr(state, k))
    want = [(k, tuple(p.shape)) for k, p in flatten_with_paths(params)]
    moments = []
    for name in ("m", "v"):
        tree = get(name)
        have = [(k, tuple(np.shape(a))) for k, a in flatten_with_paths(tree)]
        if have != want:
            raise ValueError(f"OptState.{name}: leaves {have} are not the "
                             f"parameters' {want}")
        moments.append(map_tree(
            lambda a: _tensor(a, device, torch.float32), tree))
    count = _tensor(np.asarray(get("count")), device, torch.int32)
    if count.dim() != 0:
        raise ValueError(f"OptState.count must be a scalar, got shape "
                         f"{tuple(count.shape)}")
    return OptState(moments[0], moments[1], count)
