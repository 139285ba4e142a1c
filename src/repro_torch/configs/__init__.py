"""Architecture registry of the port: one module per arch it serves so
far (the JAX package's configs, verbatim).  Each module exposes

* ``FAMILY``        — "lm" | "recsys"
* ``CONFIG``        — the full-size config
* ``smoke_config()``— reduced same-family config for CPU tests
* ``SKIP_SHAPES``   — shape names this arch cannot run (with the reason)

The other LM archs and the GNN archs come with the modules they need
(``ROADMAP.md`` queue 1).
"""
from __future__ import annotations

import importlib
from typing import List

ARCH_IDS: List[str] = ["glm4-9b", "dlrm-rm2"]

_MODULES = {
    "glm4-9b": "glm4_9b",
    "dlrm-rm2": "dlrm_rm2",
}


def get_arch(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
