"""``BENCHMARK.json`` and the files it names, found by name.

A cell is a ``workloads`` entry: a configuration (``configs`` entry, its
``file``), a traffic mix (``traffic/<traffic>.json``) and the metrics
whose ``workloads`` list it (or that list none).  Mixes, graph
generators (``graphs/<kind>.py``) and metric readers
(``metrics/<metric>.py``) are looked up under each directory of
``paths`` in turn, so a later change adds one by adding a file.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import List

__all__ = ["Cell", "load", "cell", "find", "load_module"]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration's file
    traffic: dict           # the mix's file
    end_to_end: List[dict]  # BENCHMARK.json's metric entries for this cell
    per_layer: List[dict]


def load(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def find(root: Path, bench: dict, sub: str, name: str) -> Path:
    """``<path>/<sub>/<name>`` under the first of ``paths`` that has it."""
    for p in bench["paths"]:
        f = Path(root) / p / sub / name
        if f.is_file():
            return f
    raise FileNotFoundError(f"no {sub}/{name} under {bench['paths']}")


def load_module(path: Path):
    """Import a file of the benchmark by its path (its name may hold
    ``.`` or ``-``, as a metric's does)."""
    mod_name = "hodbench_file_" + re.sub(r"\W", "_", str(path))
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def cell(root: Path, bench: dict, workload: str) -> Cell:
    """The cell named ``workload``; ``KeyError`` if there is none."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(by_name)})")
    w = by_name[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=json.loads((Path(root) / conf["file"]).read_text()),
        traffic=json.loads(find(root, bench, "traffic",
                                f"{w['traffic']}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])
