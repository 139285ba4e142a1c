"""HoD index file organization (paper §4.5), packed for TPU sweeps.

The paper stores removed nodes' out-edges in a forward file ``F_f``
(ascending rank order) and in-edges in a backward file ``F_b`` (descending
rank order), so both query scans are sequential.  Here the same invariant —
*file order == traversal order* — becomes *chunk order == scan order*:

* forward edges are grouped by the **rank level of their source** and packed
  into fixed-size chunks that never straddle a level boundary, so a
  ``lax.scan`` over chunks relaxes each node only after its distance is
  final (the level graph is a DAG: every ``F_f``/``F_b`` edge goes strictly
  up-rank, and no two same-rank nodes are adjacent — §4.2);
* backward edges are grouped by the **level of their destination** and laid
  out in descending level order, mirroring the reversed ``F_b`` file;
* the core graph is closed transitively at build time (Floyd–Warshall), so
  the query-time core search is a single min-plus matmul against the
  closure — a beyond-paper optimization; the raw core CSR is kept for the
  paper-faithful iterative modes;
* on top of the chunk arrays, ``pack_index`` builds a :class:`SweepPlan`
  per sweep direction — the padded, static-shape ``[L_pad, M_pad, K_fix]``
  bucketed layout the query executor scans (DESIGN.md §5).  Plans are
  persisted inside the ``.npz`` (format version 2) so an index load never
  re-derives the layout; version-1 files rebuild it with a warning.

Padding edges use the sentinel node ``n`` with length +inf: they relax into
a scrap column and can never win a min.

This module keeps the JAX package's index layout array for array, so an
index packed here equals one packed there, and an ``.npz`` written by
either loads in the other (:func:`index_from_numpy`).  Only the core
closure differs in how it is computed: plain torch on the build device.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .build import BuildResult
from .graph import Digraph

__all__ = ["HoDIndex", "SweepPlan", "build_sweep_plan",
           "build_core_plan", "pack_index", "index_from_numpy",
           "floyd_warshall_closure", "FORMAT_VERSION",
           "scan_cost_bytes", "core_scan_bytes",
           "plan_level_ids", "node_levels"]

INF = np.float32(np.inf)


def scan_cost_bytes(rows: int, edges: int, include_assoc: bool = False,
                    id_itemsize: int = 4, w_itemsize: int = 4) -> int:
    """Compact-payload cost of one sequential sweep over a plan: one dst
    id per real row plus (src, w[, assoc]) per real edge.  THE scan cost
    model, the same as the JAX package's, so the two packages charge
    equal modeled I/O for equal plans."""
    per_edge = id_itemsize + w_itemsize \
        + (id_itemsize if include_assoc else 0)
    return rows * id_itemsize + edges * per_edge


def core_scan_bytes(ix: "HoDIndex", core_mode: str) -> int:
    """Bytes one core search reads: the dense closure for
    ``core_mode="closure"``, the raw CSR otherwise — never both."""
    if core_mode == "closure":
        return int(ix.core_closure.nbytes)
    return int(ix.core_ptr.nbytes + ix.core_dst.nbytes + ix.core_w.nbytes)

#: Index layout version, as the JAX package numbers it.  v1 = chunk
#: arrays only (plans re-derived at load time); v2 = chunk arrays +
#: serialized SweepPlans; v3–v5 changed only the disk-resident block
#: store (``storage/blockfile.py``): their ``.npz`` keys are those of v2.
#: Every version's ``.npz`` and every v3–v5 store loads here.
FORMAT_VERSION = 5


@dataclasses.dataclass
class SweepPlan:
    """Padded, static-shape per-level bucketed sweep layout (DESIGN.md §5).

    All arrays share the ``[L_pad, M_pad, K_fix]`` envelope so the query
    executor can run the whole sweep as ONE ``lax.scan`` over the level
    axis — one jit trace regardless of how many levels the graph has.
    Padding is absorbing under (min, +): padding rows/slots point at the
    sentinel column with ``+inf`` weight and ``-1`` assoc, padding levels
    are all-padding rows, and ``row_valid`` / ``level_mask`` make the
    masking explicit for the kernel.
    """

    dst: np.ndarray         # [L_pad, M_pad]         int32, sentinel padding
    src_idx: np.ndarray     # [L_pad, M_pad, K_fix]  int32, sentinel padding
    w: np.ndarray           # [L_pad, M_pad, K_fix]  f32, +inf padding
    assoc: np.ndarray       # [L_pad, M_pad, K_fix]  int32, -1 padding
    row_valid: np.ndarray   # [L_pad, M_pad]         bool, False on padding
    level_mask: np.ndarray  # [L_pad]                bool, False on padding

    @property
    def l_pad(self) -> int:
        return int(self.dst.shape[0])

    @property
    def m_pad(self) -> int:
        return int(self.dst.shape[1])

    @property
    def k_fix(self) -> int:
        return int(self.src_idx.shape[2])

    @property
    def n_real_levels(self) -> int:
        return int(self.level_mask.sum())

    def scan_bytes(self, include_assoc: bool = False) -> int:
        """Modeled sequential-scan footprint of one sweep over this plan:
        the *compact* payload a disk layout would stream — one dst id per
        real row plus (src, w[, assoc]) per real edge.  The static
        padding envelope is a layout artifact, not file content, so it
        is not charged (charging it would inflate the paper-comparable
        I/O numbers ~10x on level-skewed graphs)."""
        return scan_cost_bytes(
            rows=int(self.row_valid.sum()),
            edges=int(np.isfinite(self.w).sum()),
            include_assoc=include_assoc,
            id_itemsize=self.src_idx.itemsize,
            w_itemsize=self.w.itemsize)

    def nbytes(self) -> int:
        """In-memory (padded) footprint of the plan arrays."""
        return int(self.dst.nbytes + self.src_idx.nbytes + self.w.nbytes
                   + self.assoc.nbytes + self.row_valid.nbytes
                   + self.level_mask.nbytes)


def _empty_plan(k_fix: int) -> SweepPlan:
    return SweepPlan(
        dst=np.zeros((0, 1), np.int32),
        src_idx=np.zeros((0, 1, k_fix), np.int32),
        w=np.zeros((0, 1, k_fix), np.float32),
        assoc=np.zeros((0, 1, k_fix), np.int32),
        row_valid=np.zeros((0, 1), bool),
        level_mask=np.zeros((0,), bool))


def _bucket_rows(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                 assoc: np.ndarray, k_fix: int, sentinel: int):
    """Bucket one level's edges by destination into padded ``[M, K]`` rows.

    A destination with more than ``k_fix`` in-edges owns ``ceil(indeg/K)``
    rows; splitting is lossless because rows of one destination are merged
    by the executor's scatter-min (scatter-max for assoc reconstruction).
    """
    o = np.argsort(dst, kind="stable")
    s_l, d_l, w_l, a_l = src[o], dst[o], w[o], assoc[o]
    uniq, starts, counts = np.unique(d_l, return_index=True,
                                     return_counts=True)
    rows_per = -(-counts // k_fix)
    row_off = np.concatenate([[0], np.cumsum(rows_per)])
    grp = np.repeat(np.arange(uniq.size), counts)
    pos = np.arange(d_l.size) - np.repeat(starts, counts)
    row, col = row_off[grp] + pos // k_fix, pos % k_fix
    m = int(row_off[-1])
    src_idx = np.full((m, k_fix), sentinel, dtype=np.int32)
    w_bkt = np.full((m, k_fix), INF, dtype=np.float32)
    a_bkt = np.full((m, k_fix), -1, dtype=np.int32)
    src_idx[row, col] = s_l
    w_bkt[row, col] = w_l
    a_bkt[row, col] = a_l
    return (np.repeat(uniq, rows_per).astype(np.int32), src_idx, w_bkt,
            a_bkt)


def _stack_levels(levels, k_fix: int, sentinel: int, m_align: int = 8,
                  l_align: int = 1) -> SweepPlan:
    """Pad per-level ``[M_l, K]`` buckets to a common static envelope."""
    if not levels:
        return _empty_plan(k_fix)
    m_pad = max(d.shape[0] for (d, _, _, _) in levels)
    m_pad = max(m_align, -(-m_pad // m_align) * m_align)
    l_real = len(levels)
    l_pad = -(-l_real // l_align) * l_align
    dst = np.full((l_pad, m_pad), sentinel, np.int32)
    src_idx = np.full((l_pad, m_pad, k_fix), sentinel, np.int32)
    w = np.full((l_pad, m_pad, k_fix), INF, np.float32)
    assoc = np.full((l_pad, m_pad, k_fix), -1, np.int32)
    row_valid = np.zeros((l_pad, m_pad), bool)
    level_mask = np.zeros((l_pad,), bool)
    for i, (d_l, s_l, w_l, a_l) in enumerate(levels):
        m = d_l.shape[0]
        dst[i, :m] = d_l
        src_idx[i, :m] = s_l
        w[i, :m] = w_l
        assoc[i, :m] = a_l
        row_valid[i, :m] = True
        level_mask[i] = True
    return SweepPlan(dst=dst, src_idx=src_idx, w=w, assoc=assoc,
                     row_valid=row_valid, level_mask=level_mask)


def build_sweep_plan(ix: "HoDIndex", forward: bool,
                     k_cap: int = 16) -> SweepPlan:
    """Derive a static-shape :class:`SweepPlan` from the flat chunk arrays.

    The chunk arrays are level-aligned (DESIGN.md §4), so every real
    edge's level is recoverable from its level-defining endpoint: the
    *source* for forward edges, the *destination* for backward edges.
    Levels are emitted in sweep order — ascending for the forward sweep,
    descending for the backward sweep — empty levels are dropped, and the
    survivors are padded to one common ``[M_pad, K_fix]`` rectangle.
    """
    if forward:
        src, dst, w, assoc = ix.f_src, ix.f_dst, ix.f_w, ix.f_assoc
    else:
        src, dst, w, assoc = ix.b_src, ix.b_dst, ix.b_w, ix.b_assoc
    src, dst = src.reshape(-1), dst.reshape(-1)
    w, assoc = w.reshape(-1), assoc.reshape(-1)
    real = np.isfinite(w)
    src, dst, w, assoc = src[real], dst[real], w[real], assoc[real]
    if src.size == 0:
        return _empty_plan(k_cap)
    key = src if forward else dst
    lvl = np.searchsorted(ix.level_ptr, key, side="right") - 1

    levels = []
    order = range(ix.n_levels) if forward else range(ix.n_levels - 1, -1, -1)
    for level in order:
        sel = lvl == level
        if not sel.any():
            continue
        levels.append(_bucket_rows(src[sel], dst[sel], w[sel], assoc[sel],
                                   k_cap, ix.n))
    # l_align > 1 pads the level axis too: padding levels are all-padding
    # rows with level_mask=False, absorbed by the executor's masking.
    return _stack_levels(levels, k_cap, ix.n, l_align=4)


def plan_level_ids(ix: "HoDIndex", forward: bool) -> np.ndarray:
    """Graph level of each *real* plan level, in the plan's scan order.

    ``build_sweep_plan`` drops empty levels, so plan level ``j`` is not
    graph level ``j`` — this recovers the mapping from the (resident)
    chunk arrays without materializing the plan, mirroring
    :func:`build_sweep_plan`'s selection exactly: ascending non-empty
    levels for the forward plan, descending for the backward plan.
    This is the meet-node metadata the point-to-point / threshold query
    modes use to skip provably-inert plan levels (DESIGN.md §7): a P2P
    backward-label sweep for target ``t`` starts at ``t``'s level, a
    forward sweep from ``s`` at ``s``'s level.
    """
    if forward:
        key, w = ix.f_src.reshape(-1), ix.f_w.reshape(-1)
    else:
        key, w = ix.b_dst.reshape(-1), ix.b_w.reshape(-1)
    key = key[np.isfinite(w)]
    if key.size == 0:
        return np.zeros(0, np.int32)
    lvl = np.searchsorted(ix.level_ptr, key, side="right") - 1
    present = np.unique(lvl).astype(np.int32)       # ascending
    return present if forward else present[::-1].copy()


def node_levels(ix: "HoDIndex", perm_ids: np.ndarray) -> np.ndarray:
    """Graph level of each *permuted* node id (core nodes report
    ``n_levels`` — above every removal level)."""
    perm_ids = np.asarray(perm_ids)
    lvl = (np.searchsorted(ix.level_ptr, perm_ids, side="right") - 1)
    return np.where(perm_ids >= ix.n_noncore, ix.n_levels,
                    lvl).astype(np.int32)


def build_core_plan(ix: "HoDIndex", k_cap: int = 16) -> SweepPlan:
    """Bucket the raw core edges (permuted *global* ids) as a one-level
    plan.  Distances are final when SSSP reconstruction runs, so the core
    edges need no level structure — they ride the same executor as one
    extra plan level (DESIGN.md §5)."""
    if ix.core_dst.shape[0] == 0:
        return _empty_plan(k_cap)
    cu = np.repeat(np.arange(ix.n_core, dtype=np.int32),
                   np.diff(ix.core_ptr))
    src = (cu + ix.n_noncore).astype(np.int32)
    dst = (ix.core_dst + ix.n_noncore).astype(np.int32)
    return _stack_levels(
        [_bucket_rows(src, dst, ix.core_w.astype(np.float32),
                      ix.core_assoc, k_cap, ix.n)], k_cap, ix.n)


@dataclasses.dataclass
class HoDIndex:
    """Query-ready HoD index. All arrays numpy; node ids are *permuted* ids
    (removal order first, core last); ``assoc`` values are original ids."""

    n: int                    # original node count
    n_pad: int                # padded node dim (sentinel column + alignment)
    n_noncore: int
    n_core: int
    n_levels: int
    chunk: int
    perm: np.ndarray          # [n] original id -> permuted id
    inv_perm: np.ndarray      # [n] permuted id -> original id
    level_ptr: np.ndarray     # [n_levels+1] permuted-node ranges per level
    rank: np.ndarray          # [n] per original id (1-based; core = L+1)

    # forward sweep chunks: ascending level order  [n_chunks_f, chunk]
    f_src: np.ndarray
    f_dst: np.ndarray
    f_w: np.ndarray
    f_assoc: np.ndarray

    # backward sweep chunks: descending level order  [n_chunks_b, chunk]
    b_src: np.ndarray
    b_dst: np.ndarray
    b_w: np.ndarray
    b_assoc: np.ndarray

    # core graph: dense closure + raw CSR (paper-faithful modes)
    core_closure: np.ndarray  # [C, C] f32, closure[i, j] = dist in G_c
    core_diameter: int        # max hop count of any core shortest path
    core_ptr: np.ndarray      # raw core CSR (core-local ids)
    core_dst: np.ndarray
    core_w: np.ndarray
    core_assoc: np.ndarray    # original-id predecessor annotation

    # static-shape sweep plans (DESIGN.md §5): built by pack_index,
    # serialized since format v2, rebuilt (with a warning) for v1 files
    plan_f: Optional[SweepPlan] = None
    plan_b: Optional[SweepPlan] = None
    plan_core: Optional[SweepPlan] = None
    k_cap: int = 16
    format_version: int = FORMAT_VERSION

    def ensure_plans(self, k_cap: Optional[int] = None) -> "HoDIndex":
        """Build any missing sweep plan in place (no-op when present).

        ``k_cap`` only applies to plans being built; existing plans keep
        the ``K_fix`` they were packed with.
        """
        k = int(k_cap if k_cap is not None else self.k_cap)
        if self.plan_f is None:
            self.plan_f = build_sweep_plan(self, forward=True, k_cap=k)
        if self.plan_b is None:
            self.plan_b = build_sweep_plan(self, forward=False, k_cap=k)
        if self.plan_core is None:
            self.plan_core = build_core_plan(self, k_cap=k)
        return self

    def plan_bytes(self) -> int:
        """In-memory (padded) footprint of the three sweep plans.

        Reported separately from :meth:`index_bytes`: the padding
        envelope is ~10x the real payload on level-skewed graphs and
        would swamp the paper-comparable size accounting.
        """
        plans = (self.plan_f, self.plan_b, self.plan_core)
        return sum(p.nbytes() for p in plans if p is not None)

    def index_bytes(self) -> int:
        """On-'disk' size of the index core content (Table 3 accounting:
        chunk files + core + permutation — the paper-comparable number).
        The v2 file additionally serializes the sweep plans; see
        :meth:`plan_bytes` for their (padded) footprint."""
        arrays = (self.f_src, self.f_dst, self.f_w, self.f_assoc,
                  self.b_src, self.b_dst, self.b_w, self.b_assoc,
                  self.core_closure, self.core_ptr, self.core_dst,
                  self.core_w, self.core_assoc, self.perm, self.level_ptr)
        return int(sum(a.nbytes for a in arrays))

    @property
    def m_aug(self) -> int:
        """Edges in the augmented graph (m' in the paper's complexity)."""
        real_f = int((self.f_w != INF).sum()) if self.f_w.size else 0
        real_b = int((self.b_w != INF).sum()) if self.b_w.size else 0
        return real_f + real_b + int(self.core_dst.shape[0])

    # -- serialization ------------------------------------------------------
    _PLAN_PREFIXES = (("plan_f", "pf"), ("plan_b", "pb"),
                      ("plan_core", "pc"))
    #: the non-plan array roster — the single source of truth shared by
    #: ``save`` and :func:`index_from_numpy`, and the same roster as the
    #: JAX package's ``.npz`` files, so a new index array cannot be
    #: silently dropped from one path.
    _ARRAY_FIELDS = ("perm", "inv_perm", "level_ptr", "rank",
                     "f_src", "f_dst", "f_w", "f_assoc",
                     "b_src", "b_dst", "b_w", "b_assoc",
                     "core_closure", "core_ptr", "core_dst", "core_w",
                     "core_assoc")

    def resident_arrays(self) -> Dict[str, np.ndarray]:
        """name -> array for every non-plan field (the store's
        always-in-memory tier)."""
        return {k: getattr(self, k) for k in self._ARRAY_FIELDS}

    def _meta_array(self) -> np.ndarray:
        return np.array([self.n, self.n_pad, self.n_noncore, self.n_core,
                         self.n_levels, self.chunk, self.core_diameter],
                        dtype=np.int64)

    @classmethod
    def _from_npz(cls, z: Mapping[str, np.ndarray]) -> "HoDIndex":
        """The plan-less index from an open ``.npz`` mapping (shared by
        :func:`index_from_numpy` and ``storage.IndexStore``)."""
        meta = np.asarray(z["meta"])
        return cls(
            n=int(meta[0]), n_pad=int(meta[1]), n_noncore=int(meta[2]),
            n_core=int(meta[3]), n_levels=int(meta[4]), chunk=int(meta[5]),
            core_diameter=int(meta[6]),
            **{k: np.asarray(z[k]) for k in cls._ARRAY_FIELDS},
            format_version=(int(z["format_version"])
                            if "format_version" in z else 1),
            k_cap=int(z["k_cap"]) if "k_cap" in z else 16)

    def save(self, path: str) -> None:
        """Write the monolithic ``.npz`` layout: chunk arrays + sweep
        plans (one blob, fully resident on load).  For the disk-resident
        serving format see :meth:`save_store`."""
        self.ensure_plans()
        plans = {}
        for field, pre in self._PLAN_PREFIXES:
            p: SweepPlan = getattr(self, field)
            plans[f"{pre}_dst"] = p.dst
            plans[f"{pre}_src"] = p.src_idx
            plans[f"{pre}_w"] = p.w
            plans[f"{pre}_assoc"] = p.assoc
            plans[f"{pre}_valid"] = p.row_valid
            plans[f"{pre}_mask"] = p.level_mask
        np.savez_compressed(
            path, meta=self._meta_array(),
            format_version=np.int64(FORMAT_VERSION),
            k_cap=np.int64(self.k_cap),
            **self.resident_arrays(), **plans)

    def save_store(self, path: str, block_bytes: int = 65536,
                   codec: str = "raw") -> None:
        """Write the disk-resident block store (a directory): the small
        resident tier plus one block segment file per sweep plan,
        readable level by level without loading the whole index, and
        byte-identical to the JAX package's.  ``codec`` picks the
        per-block compression (``"raw"`` / ``"delta"`` / ``"f16"``; see
        ``storage/blockfile.py`` and DESIGN.md §6)."""
        from ..storage.blockfile import save_store
        save_store(self, path, block_bytes=block_bytes, codec=codec)

    @staticmethod
    def load_store(path: str) -> "HoDIndex":
        """Fully materialize a store directory (plans bit-exact).
        Serving streams through ``storage.IndexStore`` instead."""
        from ..storage.blockfile import load_store
        return load_store(path)

    @staticmethod
    def load(path: str) -> "HoDIndex":
        """Load a ``.npz`` index of any format version (v1–v5), or a
        v3–v5 store directory, written by this package or by the JAX
        package.  The ``NpzFile`` is closed before return; every array is
        materialized."""
        if os.path.isdir(path):
            return HoDIndex.load_store(path)
        with np.load(path) as z:
            return index_from_numpy(z)


def index_from_numpy(arrays: Mapping[str, np.ndarray]) -> HoDIndex:
    """An :class:`HoDIndex` from the ``.npz`` key roster of
    :meth:`HoDIndex.save`: ``meta``, ``format_version``, ``k_cap``, the
    chunk/core arrays and the ``pf_*``/``pb_*``/``pc_*`` plan arrays.
    The JAX package writes the same keys, so its index arrays (a loaded
    ``.npz`` or a dict) carry across unchanged.  Version-1 rosters have
    no plans; they are rebuilt here with a warning."""
    ix = HoDIndex._from_npz(arrays)
    if f"{HoDIndex._PLAN_PREFIXES[0][1]}_dst" not in arrays:
        warnings.warn(
            f"old-format (v{ix.format_version}) HoD index without sweep "
            "plans — rebuilding the SweepPlan layout on the fly; re-save "
            "the index to persist it.", stacklevel=2)
        return ix.ensure_plans()
    for field, pre in HoDIndex._PLAN_PREFIXES:
        setattr(ix, field, SweepPlan(
            dst=np.asarray(arrays[f"{pre}_dst"]),
            src_idx=np.asarray(arrays[f"{pre}_src"]),
            w=np.asarray(arrays[f"{pre}_w"]),
            assoc=np.asarray(arrays[f"{pre}_assoc"]),
            row_valid=np.asarray(arrays[f"{pre}_valid"]),
            level_mask=np.asarray(arrays[f"{pre}_mask"])))
    return ix


def _pack_chunks(levels: List[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                    np.ndarray]],
                 chunk: int, sentinel: int):
    """Pad each level's edge list to a chunk multiple and stack.

    Level-aligned chunking is the correctness lynchpin: a chunk never mixes
    two levels, so gathers inside a chunk only read already-final rows.
    """
    srcs, dsts, ws, assocs = [], [], [], []
    for (s, d, w, a) in levels:
        if s.size == 0:
            continue
        pad = (-s.size) % chunk
        srcs.append(np.concatenate(
            [s, np.full(pad, sentinel, dtype=np.int32)]))
        dsts.append(np.concatenate(
            [d, np.full(pad, sentinel, dtype=np.int32)]))
        ws.append(np.concatenate([w, np.full(pad, INF, dtype=np.float32)]))
        assocs.append(np.concatenate([a, np.full(pad, -1, dtype=np.int32)]))
    if not srcs:
        z_i = np.zeros((0, chunk), dtype=np.int32)
        z_f = np.zeros((0, chunk), dtype=np.float32)
        return z_i, z_i.copy(), z_f, z_i.copy()
    return (np.concatenate(srcs).reshape(-1, chunk),
            np.concatenate(dsts).reshape(-1, chunk),
            np.concatenate(ws).reshape(-1, chunk).astype(np.float32),
            np.concatenate(assocs).reshape(-1, chunk))


def floyd_warshall_closure(adj: np.ndarray, device=None
                           ) -> Tuple[np.ndarray, int]:
    """All-pairs min-plus closure of the (small, memory-resident) core.

    Beyond-paper: the paper runs Dijkstra inside the core per query; closing
    the core once at build time turns every query's core search into one
    tropical matmul.  Returns (closure, hop-diameter bound).

    Plain torch on ``device`` (the card unless the caller asks for the
    CPU), one pivot step per core node in pivot order:
    ``d = min(d, d[:, k] + d[k, :])``.  Each step is one fp32 add and
    one min per entry, so the closure is bit-identical to the JAX
    package's on any device.  Row and column ``k`` do not change in
    step ``k`` (``d[k, k] == 0``), so updating ``d`` in place is exact.
    """
    c = adj.shape[0]
    if c == 0:
        return adj.astype(np.float32), 0
    d = torch.from_numpy(adj.astype(np.float32)).to(resolve_device(device))
    for k in range(c):
        torch.minimum(d, d[:, k:k + 1] + d[k:k + 1, :], out=d)
    closure = d.cpu().numpy()
    # Hop diameter of the core (for the paper-faithful Bellman–Ford mode);
    # the exact BFS bound costs O(C³·diam) — only worth it for small cores.
    hops = _hop_diameter(adj) if c <= 512 else c
    return closure, hops


def _hop_diameter(adj: np.ndarray) -> int:
    c = adj.shape[0]
    if c == 0:
        return 0
    finite = (np.isfinite(adj) & ~np.eye(c, dtype=bool)).astype(np.float32)
    reach = np.eye(c, dtype=bool)
    frontier = reach.copy()
    hops = 0
    for _ in range(c):
        nxt = ((frontier.astype(np.float32) @ finite) > 0) & ~reach
        if not nxt.any():
            break
        reach |= nxt
        frontier = nxt
        hops += 1
    return max(hops, 1)


def pack_index(g: Digraph, result: BuildResult, chunk: int = 2048,
               node_align: int = 1, closure_limit: int = 2048,
               k_cap: int = 16, device=None) -> HoDIndex:
    """Convert a :class:`BuildResult` into the packed, query-ready layout.

    The all-pairs core closure (beyond-paper fast path) is only computed
    when the core has ≤ ``closure_limit`` nodes — larger cores (scale-free
    fill-in) fall back to the paper-faithful iterative core search; the
    stored closure is then a 0×0 placeholder and ``QueryEngine`` defaults
    to ``core_mode="bellman"``.

    The static-shape sweep plans (forward, backward, core-reconstruction —
    DESIGN.md §5) are built here once, with bucket width ``k_cap``, and
    persisted by :meth:`HoDIndex.save`.  ``device`` is where the closure
    is computed (:func:`floyd_warshall_closure`); the index itself is
    numpy on the host.
    """
    n = result.n
    order = list(result.removal_order)
    core_sorted = sorted(result.core_nodes)
    n_noncore = len(order)
    n_core = len(core_sorted)
    assert n_noncore + n_core == n

    perm = np.empty(n, dtype=np.int32)
    for new_id, old_id in enumerate(order + core_sorted):
        perm[old_id] = new_id
    inv_perm = np.empty(n, dtype=np.int32)
    inv_perm[perm] = np.arange(n, dtype=np.int32)

    n_levels = len(result.level_sizes)
    level_ptr = np.zeros(n_levels + 1, dtype=np.int64)
    np.cumsum(result.level_sizes, out=level_ptr[1:])

    n_pad = n + 1
    if node_align > 1:
        n_pad = -(-n_pad // node_align) * node_align
    sentinel = n  # scrap column for padding edges

    def _level_edges(adj_of, forward: bool):
        """Collect per-level (src, dst, w, assoc) with permuted endpoints."""
        levels = []
        for lvl in range(n_levels):
            lo, hi = level_ptr[lvl], level_ptr[lvl + 1]
            s_l, d_l, w_l, a_l = [], [], [], []
            for new_v in range(lo, hi):
                old_v = order[new_v]
                for (other, w_e, assoc) in adj_of[old_v]:
                    if forward:       # out-edge: removed node -> higher rank
                        s_l.append(new_v)
                        d_l.append(perm[other])
                    else:             # in-edge: higher rank -> removed node
                        s_l.append(perm[other])
                        d_l.append(new_v)
                    w_l.append(w_e)
                    a_l.append(assoc)
            levels.append((np.asarray(s_l, dtype=np.int32),
                           np.asarray(d_l, dtype=np.int32),
                           np.asarray(w_l, dtype=np.float32),
                           np.asarray(a_l, dtype=np.int32)))
        return levels

    f_levels = _level_edges(result.f_adj, forward=True)
    b_levels = _level_edges(result.b_adj, forward=False)
    b_levels.reverse()  # §4.5: F_b is scanned in descending rank order

    f_src, f_dst, f_w, f_assoc = _pack_chunks(f_levels, chunk, sentinel)
    b_src, b_dst, b_w, b_assoc = _pack_chunks(b_levels, chunk, sentinel)

    # ---- Core graph --------------------------------------------------------
    core_local = {old: i for i, old in enumerate(core_sorted)}
    csr_edges: List[List[Tuple[int, float, int]]] = \
        [[] for _ in range(n_core)]
    with_closure = n_core <= closure_limit
    adj = (np.full((n_core, n_core), INF, dtype=np.float32)
           if with_closure else None)
    if with_closure and n_core:
        np.fill_diagonal(adj, 0.0)
    for (u, v, w_e, assoc) in result.core_edges:
        cu, cv = core_local[u], core_local[v]
        if with_closure and w_e < adj[cu, cv]:
            adj[cu, cv] = w_e
        csr_edges[cu].append((cv, w_e, assoc))

    if with_closure:
        closure, diameter = floyd_warshall_closure(adj, device)
    else:
        closure = np.zeros((0, 0), np.float32)
        diameter = n_core

    core_ptr = np.zeros(n_core + 1, dtype=np.int64)
    core_dst_l, core_w_l, core_assoc_l = [], [], []
    for cu in range(n_core):
        core_ptr[cu + 1] = core_ptr[cu] + len(csr_edges[cu])
        for (cv, w_e, assoc) in csr_edges[cu]:
            core_dst_l.append(cv)
            core_w_l.append(w_e)
            core_assoc_l.append(assoc)

    ix = HoDIndex(
        n=n, n_pad=int(n_pad), n_noncore=n_noncore, n_core=n_core,
        n_levels=n_levels, chunk=chunk, perm=perm, inv_perm=inv_perm,
        level_ptr=level_ptr, rank=result.rank.astype(np.int32),
        f_src=f_src, f_dst=f_dst, f_w=f_w, f_assoc=f_assoc,
        b_src=b_src, b_dst=b_dst, b_w=b_w, b_assoc=b_assoc,
        core_closure=closure, core_diameter=diameter,
        core_ptr=core_ptr,
        core_dst=np.asarray(core_dst_l, dtype=np.int32),
        core_w=np.asarray(core_w_l, dtype=np.float32),
        core_assoc=np.asarray(core_assoc_l, dtype=np.int32),
        k_cap=int(k_cap))
    return ix.ensure_plans()
