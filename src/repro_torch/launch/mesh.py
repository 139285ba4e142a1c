"""Meshes and logical-axis rules (the JAX package's ``launch/mesh.py``).

The production meshes are data here (:func:`production_mesh_shape`):
16x16 = 256 cards a pod, and 2x16x16 = 512 for the multi-pod dry run,
axes ('pod', 'data', 'model').  Nothing builds them; the dry run will
read them.  :func:`make_smoke_mesh` is the mesh every rank of the live
group forms, ``(1, world)`` over ``("data", "model")``, and
:func:`distributed` starts (and ends) the group itself.

Rule sets map the logical axis names used by the model code to mesh
axes.  They differ by workload kind:

* train  - batch over (pod, data); FSDP (weight input dims) over data;
  TP dims (heads/mlp/experts/vocab) over model; residual-stream sequence
  sharding over model (sequence parallelism).
* serve  - no FSDP (weights replicated over data, sharded over model so
  per-layer all-gathers never sit on the decode latency path); KV cache
  sequence-sharded over model (split-KV decode).
* gnn    - nodes/edges sharded over every axis.
* recsys - batch over (pod, data); embedding rows over model; candidate
  lists over (pod, data).
"""
from __future__ import annotations

import contextlib
import math
import os
import tempfile
from typing import Dict, Iterator, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..shardlib import GROUP_TIMEOUT, make_mesh

__all__ = ["production_mesh_shape", "make_smoke_mesh", "distributed",
           "rules_train_lm", "rules_serve_lm", "rules_gnn", "rules_recsys"]


def production_mesh_shape(multi_pod: bool = False
                          ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_smoke_mesh(device=None):
    """``(1, world)`` over ``("data", "model")`` on the live group: the
    same code path as a production mesh, every rank on the model axis."""
    dev = resolve_device(device)
    return make_mesh((1, dist.get_world_size()), ("data", "model"),
                     dev.type)


@contextlib.contextmanager
def distributed(device=None) -> Iterator[torch.device]:
    """The default process group for this process, for the ``with``
    block; yields the rank's device.  The world comes from ``torchrun``'s
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``), else it is
    this one process.  On ``cuda`` the rank takes ``cuda:LOCAL_RANK``
    over NCCL; on ``cpu`` gloo.  An already live group is used as it is
    and left alive."""
    dev = resolve_device(device)
    if dist.is_initialized():
        yield dev
        return
    local = int(os.environ.get("LOCAL_RANK", 0))
    if dev.type == "cuda":
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, timeout=GROUP_TIMEOUT)
        else:
            dist.init_process_group(
                backend, init_method=f"file://{tmp}/rendezvous", rank=0,
                world_size=1, timeout=GROUP_TIMEOUT)
        try:
            yield dev
        finally:
            dist.destroy_process_group()


def _dp(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def _dp_batch(mesh, batch: int):
    """The data axes for ``batch`` when it splits evenly over them."""
    dp = _dp(mesh)
    dp_size = math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                        for a in dp) if dp else 1
    return dp if batch % max(dp_size, 1) == 0 and batch >= dp_size \
        else None


def rules_train_lm(mesh, batch: int = 0) -> Dict:
    dp = _dp(mesh)
    return {
        "batch": dp, "fsdp": "data", "heads": "model", "kv_heads": "model",
        "mlp": "model", "expert": "model", "vocab": "model", "seq": "model",
        "kv_seq": "model", "model_dim": "model", "layer_stack": None,
        "expert_mlp": None, "embed": None,
    }


def rules_serve_lm(mesh, batch: int) -> Dict:
    return {
        "batch": _dp_batch(mesh, batch), "fsdp": None, "heads": "model",
        "kv_heads": "model", "mlp": "model", "expert": "model",
        "vocab": "model", "seq": "model", "kv_seq": "model",
        "model_dim": "model", "layer_stack": None, "expert_mlp": None,
        "embed": None,
    }


def rules_gnn(mesh, batch: int = 0) -> Dict:
    dp = _dp(mesh)
    flat = dp + ("model",)
    return {
        "nodes": flat, "edges": flat, "batch": dp, "model_dim": "model",
        "layer_stack": None,
    }


def rules_recsys(mesh, batch: int) -> Dict:
    return {
        "batch": _dp_batch(mesh, batch), "rows": "model",
        "model_dim": "model", "cand": _dp(mesh), "layer_stack": None,
    }
