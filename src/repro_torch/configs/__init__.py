"""Architecture registry of the port: one module per arch it runs so far
(the JAX package's configs, verbatim).  Each module exposes

* ``FAMILY``        — "lm" | "gnn" | "recsys"
* ``CONFIG``        — the full-size config
* ``smoke_config()``— reduced same-family config for CPU tests
* ``SKIP_SHAPES``   — shape names this arch cannot run (with the reason)

The other LM archs come with the modules they need (``ROADMAP.md``
queue 1).
"""
from __future__ import annotations

import importlib
from typing import List

ARCH_IDS: List[str] = [
    "glm4-9b",
    "schnet", "gin-tu", "equiformer-v2", "gcn-cora",
    "dlrm-rm2",
]

_MODULES = {
    "glm4-9b": "glm4_9b",
    "schnet": "schnet_cfg",
    "gin-tu": "gin_tu",
    "equiformer-v2": "equiformer_v2_cfg",
    "gcn-cora": "gcn_cora",
    "dlrm-rm2": "dlrm_rm2",
}


def get_arch(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def shapes_for(arch_id: str) -> List[str]:
    from .shapes import FAMILY_SHAPES
    mod = get_arch(arch_id)
    skip = getattr(mod, "SKIP_SHAPES", {})
    return [s for s in FAMILY_SHAPES[mod.FAMILY] if s not in skip]


def all_cells() -> tuple:
    """Every runnable (arch, shape) cell + skipped ones with reasons."""
    run, skipped = [], []
    from .shapes import FAMILY_SHAPES
    for a in ARCH_IDS:
        mod = get_arch(a)
        skip = getattr(mod, "SKIP_SHAPES", {})
        for s in FAMILY_SHAPES[mod.FAMILY]:
            if s in skip:
                skipped.append((a, s, skip[s]))
            else:
                run.append((a, s))
    return run, skipped
