"""HoD build configuration and result types (paper §4).

The contract between the builder (:mod:`repro_torch.core.build_fast`)
and the packer (:mod:`repro_torch.core.index`): the memory-budget
analogue that stops contraction, the per-build statistics, and the raw
rank/adjacency output.  The dict-based reference builder is not part of
this package; ``build_hod_fast`` produces the same ``BuildResult``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from .io_sim import IOStats

__all__ = ["BuildConfig", "BuildStats", "BuildResult", "TRIPLET_BYTES"]

TRIPLET_BYTES = 20  # (node, node, length) on disk: 2×int64 + float32


@dataclasses.dataclass
class BuildConfig:
    # Memory-budget analogue: the core graph must fit these bounds ("M").
    max_core_nodes: int = 1024
    max_core_edges: int = 1 << 16
    min_shrink: float = 0.05       # §4.4 keep-going threshold
    baseline_factor: int = 5       # c in §4.3
    median_sample: int = 1024      # §4.2 approximated median
    max_rounds: int = 64
    # cap on sampled two-hop baselines per round: keeps preprocessing
    # near-linear on huge rounds; extra (unpruned) shortcuts only cost
    # space, never correctness (§4.1 safety argument)
    max_baseline_per_round: int = 200_000
    # stop contracting when shortcut fill-in outweighs removals: if the
    # reduced graph's edge count exceeds this multiple of the smallest
    # edge count seen, further rounds only inflate the index (scale-free
    # graphs; road networks never trigger it).  The survivors become the
    # core, exactly as when the §4.4 memory condition fires.
    fill_stop_ratio: float = 3.0
    seed: int = 0


@dataclasses.dataclass
class BuildStats:
    rounds: int = 0
    removed: int = 0
    candidates_generated: int = 0
    shortcuts_added: int = 0
    baselines_sampled: int = 0
    build_seconds: float = 0.0
    io: IOStats = dataclasses.field(default_factory=IOStats)
    core_nodes: int = 0
    core_edges: int = 0
    f_edges: int = 0
    b_edges: int = 0


@dataclasses.dataclass
class BuildResult:
    """Raw build output, consumed by :mod:`repro_torch.core.index`."""

    n: int
    rank: np.ndarray                 # [n] 1-based round of removal; core = rounds+1
    removal_order: List[int]         # non-core nodes, round-major
    level_sizes: List[int]           # nodes removed per round
    # forward file: per removed node, its out-edges (dst, w, assoc) at death
    f_adj: List[List[Tuple[int, float, int]]]
    # backward file: per removed node, its in-edges (src, w, assoc) at death
    b_adj: List[List[Tuple[int, float, int]]]
    core_nodes: List[int]
    # core graph edges (u, v, w, assoc) in original ids
    core_edges: List[Tuple[int, int, float, int]]
    stats: BuildStats = dataclasses.field(default_factory=BuildStats)
