"""HoD query processing (paper §5) on PyTorch: the SweepPlan executor.

An SSD query runs three phases (paper §5): a *forward search* over ``G_f``,
a *core search* inside ``G_c``, and a *backward search* over ``G_b``.
Every phase is one sequential scan of a static-shape
:class:`~repro_torch.core.index.SweepPlan` (DESIGN.md §5):

* **forward**: plan levels ascend rank; every edge goes strictly up-rank
  and same-rank nodes are never adjacent, so each node's distance is final
  before its out-edges are relaxed (single-pass DAG sweep);
* **core**: one min-plus (tropical) product against the precomputed core
  closure (the paper-faithful iterative/Dijkstra modes are kept for
  validation);
* **backward**: plan levels descend rank — the paper's heap-free linear
  scan.

This is the PyTorch counterpart of the JAX package's ``QueryEngine``,
with the same public methods and bit-identical answers.  The JAX
``lax.scan`` over plan levels becomes, for a distance sweep, one launch
of the in-place ``edge_relax`` kernel over the whole sweep (its real
levels packed once per engine into compacted rows,
:func:`~repro_torch.kernels.edge_relax.sweep.pack_sweep`), and for the
other level bodies a host loop over the plan's *real* levels (padding
levels are inert and skipped); the core search is one
``tropical_matmul`` launch.  The store-backed engine
(``storage/stream.py``) shares the plan-independent state
(:meth:`QueryEngine._init_engine`) and feeds the same level bodies one
streamed level at a time (:meth:`QueryEngine._run_plan_stream`).
Which path runs is decided by the engine's device: CUDA runs the
kernels, the CPU their plain versions.  SSSP
reconstruction, the P2P backward labels and the threshold mask stay
plain torch, as they are plain jnp in the JAX package.

Queries are batched over sources.  The label state on the device is
node-major, ``[n_pad, S]`` (one node's S labels contiguous, the layout
the kernel reads); answers leave in the JAX package's ``[S, n]``.

Under axis rules that bind ``"batch"`` (``shardlib.axis_rules``; the
reference shards its state over ``"batch"``), every rank calls the same
query with the same batch and takes a contiguous share of its sources
(:meth:`QueryEngine._share`, padded to a multiple of the ranks with the
last source repeated), runs the sweeps and the core search on its
``[n_pad, S_r]`` columns, and joins the others in one ``all_gather`` of
the answers a batch (:meth:`QueryEngine._gather`): every rank returns
the whole answer.  Sources are independent, so the answers are the
unsharded engine's bit for bit.
"""
from __future__ import annotations

import heapq
from typing import List, Tuple

import numpy as np
import torch

from .. import shardlib as sl
from ..device import resolve_device
from ..kernels.edge_relax import Sweep, pack_sweep, relax_sweep_
from ..kernels.edge_relax.sweep import PinnedStager
from ..kernels.tropical_matmul.ops import minplus
from ..obs.trace import span_if
from .index import HoDIndex, SweepPlan, plan_level_ids

__all__ = ["QueryEngine", "dijkstra_reference", "share"]

INF = float("inf")

#: One real plan level on the device: (dst [M], src_idx [M, K],
#: w [M, K], assoc [M, K], row_valid [M]).
Level = Tuple[torch.Tensor, ...]


def _knn_select(dist: np.ndarray, k: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Host top-k over a ``[S, n]`` distance matrix (original node
    order): the k smallest entries per row, ascending by ``(distance,
    node id)``; unreachable tail padded with ``(-1, +inf)``."""
    s, n = dist.shape
    nodes = np.full((s, k), -1, np.int32)
    out = np.full((s, k), np.inf, np.float32)
    ids = np.arange(n)
    for i in range(s):
        order = np.lexsort((ids, dist[i]))[:k]
        d = dist[i, order]
        m = int(np.isfinite(d).sum())     # finite entries sort first
        nodes[i, :m] = order[:m]
        out[i, :m] = d[:m]
    return nodes, out


def _plan_levels(plan: SweepPlan, n_pad: int,
                 device: torch.device) -> List[Level]:
    """The plan's real levels (``level_mask`` true), in scan order, on
    ``device``.  Each level keeps only its rows up to the last valid one
    — trailing padding rows are inert.  Indices are checked on the host
    once here, because the kernel gathers through them unchecked."""
    for name, idx in (("dst", plan.dst), ("src_idx", plan.src_idx)):
        if idx.size and (idx.min() < 0 or idx.max() >= n_pad):
            raise ValueError(f"plan {name} index outside [0, {n_pad})")
    levels = []
    for lvl in np.flatnonzero(plan.level_mask):
        m = _real_rows(plan.row_valid[lvl])
        levels.append(tuple(
            torch.from_numpy(np.ascontiguousarray(a[lvl, :m])).to(device)
            for a in (plan.dst, plan.src_idx, plan.w, plan.assoc,
                      plan.row_valid)))
    return levels


def _real_rows(valid: np.ndarray) -> int:
    """Rows of a level up to its last valid one (trailing padding rows
    are inert)."""
    rows = np.flatnonzero(valid)
    return int(rows[-1]) + 1 if rows.size else 0


def _upload_slab(slab: Tuple[np.ndarray, ...], n_pad: int,
                 stager: PinnedStager) -> Level:
    """One streamed level slab ``(dst, src_idx, w, assoc, row_valid)``
    on the stager's device, as :func:`_plan_levels` keeps a level: rows
    up to the last valid one, indices checked on the host."""
    dst, src_idx = slab[:2]
    m = _real_rows(slab[4])
    for name, idx in (("dst", dst[:m]), ("src_idx", src_idx[:m])):
        if idx.size and (idx.min() < 0 or idx.max() >= n_pad):
            raise ValueError(f"slab {name} index outside [0, {n_pad})")
    return tuple(stager.stage([a[:m] for a in slab]))


def _plan_sweep(plan: SweepPlan, n_pad: int, device: torch.device) -> Sweep:
    """The plan's real levels, in scan order, packed for ``relax_sweep_``
    on ``device``: one row per distinct destination a level, finite
    slots only."""
    return pack_sweep([(plan.dst[lvl], plan.src_idx[lvl], plan.w[lvl],
                        plan.row_valid[lvl])
                       for lvl in np.flatnonzero(plan.level_mask)],
                      n_pad, device)


def _dense_core_adjacency(ix: HoDIndex) -> np.ndarray:
    """Dense [C, C] core adjacency from the raw CSR (scatter, no Python
    loop) — only the paper-faithful Bellman core mode reads it."""
    c = ix.n_core
    adj = np.full((c, c), np.inf, dtype=np.float32)
    if c:
        np.fill_diagonal(adj, 0.0)
        if ix.core_dst.shape[0]:
            cu = np.repeat(np.arange(c, dtype=np.int32),
                           np.diff(ix.core_ptr))
            np.minimum.at(adj, (cu, ix.core_dst),
                          ix.core_w.astype(np.float32))
    return adj


def share(nodes, n: int, i: int) -> np.ndarray:
    """Share ``i`` of ``n`` of a batch (``[S]`` or ``[S, ...]``): the
    batch padded to a multiple of ``n`` by repeating its last entry, then
    cut into ``n`` contiguous shares."""
    nodes = np.asarray(nodes)
    per = -(-nodes.shape[0] // n)
    pad = np.repeat(nodes[-1:], per * n - nodes.shape[0], axis=0)
    return np.concatenate([nodes, pad])[i * per:(i + 1) * per]


class QueryEngine:
    """Batched SSD/SSSP execution over a packed :class:`HoDIndex`.

    core_mode:
      * ``"closure"``  — beyond-paper: single tropical product (default)
      * ``"bellman"``  — iterative min-plus to fixpoint (diameter-
                          bounded), closest in spirit to scanning G_c
      * ``"dijkstra"`` — paper-faithful host-side heap Dijkstra on the core

    ``device`` is where the sweeps run: ``"cuda"`` (the default, through
    the hand-written kernels) or ``"cpu"`` (their plain versions).
    """

    #: Optional :class:`repro_torch.obs.trace.Tracer` (DESIGN.md §11),
    #: set by the server or the streaming engine; ``None`` keeps every
    #: hook inert.  An in-memory sweep is one launch and emits no
    #: per-level span, as the reference's ``lax.scan`` emits none; the
    #: in-memory engine spans its phases instead (``phase.forward``,
    #: ``phase.core``, ``phase.backward``, ``phase.recon``,
    #: ``phase.to_host``), on the host: a span ends when its launches
    #: return, and none synchronizes the card.  The store-backed
    #: engine's queries do not pass through them.
    tracer = None

    def __init__(self, index: HoDIndex, core_mode: str = "closure",
                 eps: float = 0.0, k_cap: int = 16, device=None):
        self._init_engine(index, core_mode, eps, device)
        index.ensure_plans(k_cap)   # no-op for pack_index/v2+-load indexes
        dev = self.device
        self._levels_f = _plan_levels(index.plan_f, index.n_pad, dev)
        self._levels_b = _plan_levels(index.plan_b, index.n_pad, dev)
        self._levels_c = _plan_levels(index.plan_core, index.n_pad, dev)
        self._sweep_f = _plan_sweep(index.plan_f, index.n_pad, dev)
        self._sweep_b = _plan_sweep(index.plan_b, index.n_pad, dev)

    def _init_engine(self, index: HoDIndex, core_mode: str, eps: float,
                     device) -> None:
        """Plan-independent engine state: everything a level body or the
        core search needs that is not a plan on the device.  Shared with
        the store-backed ``storage.StreamingQueryEngine``, which feeds
        plan levels from the page cache instead of uploading them
        whole."""
        if core_mode not in ("closure", "bellman", "dijkstra"):
            raise ValueError(core_mode)
        self.device = resolve_device(device)
        if core_mode == "closure" and index.n_core \
                and index.core_closure.shape[0] == 0:
            core_mode = "bellman"   # closure skipped at pack time (big core)
        self.index = index
        self.core_mode = core_mode
        self.eps = float(eps)
        dev = self.device
        self._perm = torch.from_numpy(index.perm.astype(np.int64)).to(dev)
        self._closure = (torch.from_numpy(index.core_closure).to(dev)
                         if core_mode == "closure" else None)
        # Dense core adjacency is only materialized for the mode that
        # scans it; closure/dijkstra engines skip the [C, C] build.
        self._core_adj = (torch.from_numpy(_dense_core_adjacency(index))
                          .to(dev) if core_mode == "bellman" else None)
        # The graph level behind each real plan level, in scan order
        # (DESIGN.md §7), from the resident chunk arrays: the bounded
        # sweeps of the store-backed engine skip provably inert levels
        # by it without materializing a plan.
        self._level_ids_f = plan_level_ids(index, forward=True)
        self._level_ids_b = plan_level_ids(index, forward=False)

    # ------------------------------------------------------- plan executor
    @staticmethod
    def _run_plan(state: torch.Tensor, levels: List[Level], level_body,
                  reverse: bool = False) -> torch.Tensor:
        """The sweep executor: ``level_body(state, dst, src_idx, w, assoc,
        valid) -> state`` over each real level in scan order
        (``reverse=True`` walks them back to front, as the P2P
        backward-label sweep walks ``plan_b`` in ascending rank)."""
        for lvl in (reversed(levels) if reverse else levels):
            state = level_body(state, *lvl)
        return state

    def _run_plan_stream(self, state: torch.Tensor, slabs, level_body,
                         stager: PinnedStager,
                         label: str = None) -> torch.Tensor:
        """The streamed twin of :meth:`_run_plan`: ``slabs`` yields host
        ``(dst, src_idx, w, assoc, valid)`` level slabs in scan order
        (from the store's page cache, DESIGN.md §6); each one's rows up
        to its last valid row move to the device in one copy
        (:func:`_upload_slab`) and ``level_body`` runs on them.  One
        level lives on the device at a time.  With a tracer and a
        ``label`` (the plan name of a full sweep) each level's upload
        and body run inside a ``level.relax`` span; a bounded sweep's
        single level passes no label and emits none, as in the
        reference."""
        tracer = self.tracer if label is not None else None
        for lvl, slab in enumerate(slabs):
            with span_if(tracer, "level.relax", plan=label, level=lvl):
                level = _upload_slab(slab, self.index.n_pad, stager)
                state = level_body(state, *level)
                del level
        return state

    @staticmethod
    def _relax_sweep(dist: torch.Tensor, sweep: Sweep,
                     d: float = None) -> torch.Tensor:
        """Distance relaxation over a whole sweep (SSD sweeps, DESIGN.md
        §5), in place: one ``edge_relax`` launch on CUDA.  A level's
        gathered sources and written destinations are disjoint (DESIGN.md
        §3).  With a threshold ``d`` (DESIGN.md §7) each level runs on
        its own and is followed by the mask: any label that exceeds ``d``
        is snapped back to ``+inf`` inside the sweep, so it never seeds
        further relaxations (sound because weights are positive)."""
        if d is None:
            return relax_sweep_(dist, sweep)
        for i in range(sweep.n_levels):
            relax_sweep_(dist, sweep.level(i))
            dist.masked_fill_(~(dist <= d), INF)
        return dist

    @staticmethod
    def _relax_level_rev(dlab, dst, src_idx, w, assoc, valid):
        """Reverse relaxation for one level: backward *labels* (P2P mode,
        DESIGN.md §7).  ``dlab[x] = min(dlab[x], w + dlab[v])`` for each
        backward edge ``(x -> v, w)``: gather at ``dst``, scatter-min
        into the higher-rank ``src_idx`` slots.  Padding slots carry
        ``+inf`` weight and sentinel sources — absorbing."""
        s = dlab.shape[1]
        cand = dlab.index_select(0, dst.long())[:, None, :] + w[:, :, None]
        cand = torch.where(valid[:, None, None], cand, INF)   # [M, K, S]
        idx = src_idx.reshape(-1, 1).long().expand(-1, s)
        return dlab.scatter_reduce_(0, idx, cand.reshape(-1, s), "amin",
                                    include_self=True)

    def _recon_level(self, pred, dist, dst, src_idx, w, assoc, valid):
        """SSSP predecessor reconstruction for one level (§6): scatter
        the assoc of every tight edge, max-merged (-1 = none)."""
        s = dist.shape[1]
        cand = dist.index_select(0, src_idx.reshape(-1).long()) \
            .reshape(*src_idx.shape, s) + w[:, :, None]       # [M, K, S]
        tgt = dist.index_select(0, dst.long())                # [M, S]
        tight = torch.isfinite(cand) \
            & (cand <= (tgt + self.eps * (1.0 + tgt))[:, None, :])
        tight &= valid[:, None, None]
        pcand = torch.where(tight, assoc[:, :, None], -1).amax(dim=1)
        return pred.scatter_reduce_(0, dst.long()[:, None].expand(-1, s),
                                    pcand, "amax", include_self=True)

    def _recon_level_body(self, dist):
        """:meth:`_recon_level` with ``dist`` bound, in the executor's
        level-body signature."""
        def body(pred, dst, src_idx, w, assoc, valid):
            return self._recon_level(pred, dist, dst, src_idx, w, assoc,
                                     valid)

        return body

    # ------------------------------------------------------------------ SSD
    def _core_update(self, dist: torch.Tensor) -> torch.Tensor:
        """Core search (§5.2) on the core block of ``dist``, written back
        into that view in place.  The min-plus product takes the block
        source-major (``[S, C]``, rows contiguous), so it is transposed
        on the way in and out."""
        ix = self.index
        c = ix.n_core
        if c == 0:
            return dist
        core = dist[ix.n_noncore:ix.n_noncore + c]      # a view of dist
        d = core.t().contiguous()                       # [S, C]
        if self.core_mode == "bellman":
            # Iterate min-plus relaxation to fixpoint — the closest
            # analogue of the paper's in-memory core scan.  Converges in
            # at most C-1 rounds; one host sync per round.
            for _ in range(c):
                nd = torch.minimum(d, minplus(d, self._core_adj))
                changed = bool((nd < d).any())
                d = nd
                if not changed:
                    break
        else:  # closure
            d = minplus(d, self._closure)
        core.copy_(d.t())
        return dist

    def _init_state(self, nodes_perm: np.ndarray) -> torch.Tensor:
        """[n_pad, S] all-+inf label state with 0 at each column's
        node."""
        s = len(nodes_perm)
        state = torch.full((self.index.n_pad, s), INF, dtype=torch.float32,
                           device=self.device)
        rows = torch.from_numpy(np.asarray(nodes_perm, np.int64)) \
            .to(self.device)
        state[rows, torch.arange(s, device=self.device)] = 0.0
        return state

    def _core_search(self, dist: torch.Tensor) -> torch.Tensor:
        """The core search (§5.2) in the engine's core mode: the host
        heap for ``dijkstra``, else :meth:`_core_update`."""
        if not self.index.n_core:
            return dist
        if self.core_mode == "dijkstra":
            host = dist.cpu().numpy()                   # [n_pad, S]
            self._core_dijkstra_host(host.T)
            return torch.from_numpy(host).to(self.device)
        return self._core_update(dist)

    def _forward_core(self, sources_perm: np.ndarray,
                      d: float = None) -> torch.Tensor:
        """Forward search (§5.1) + core search (§5.2): the shared first
        two phases of SSD, P2P, and threshold queries (``d``)."""
        with span_if(self.tracer, "phase.forward"):
            dist = self._relax_sweep(self._init_state(sources_perm),
                                     self._sweep_f, d)
        with span_if(self.tracer, "phase.core"):
            return self._core_search(dist)

    def _ssd_dev(self, sources_perm: np.ndarray) -> torch.Tensor:
        dist = self._forward_core(sources_perm)
        with span_if(self.tracer, "phase.backward"):    # §5.3
            return self._relax_sweep(dist, self._sweep_b)

    def _sssp_dev(self, sources_perm: np.ndarray):
        dist = self._ssd_dev(sources_perm)
        with span_if(self.tracer, "phase.recon"):
            pred = torch.full(dist.shape, -1, dtype=torch.int32,
                              device=self.device)
            recon = self._recon_level_body(dist)
            # The per-plan reconstruction scatters are max-merges over a
            # fixed `dist`, so the plan order commutes.
            for levels in (self._levels_f, self._levels_c, self._levels_b):
                pred = self._run_plan(pred, levels, recon)
        return dist, pred

    def _to_host(self, state: torch.Tensor) -> np.ndarray:
        """``[n_pad, S]`` device state -> ``[S, n]`` host array in
        original node order (gathered and transposed on the device, in
        one launch: ``index_select`` writes a contiguous result); under
        a batch split, every rank's rows (:meth:`_gather`)."""
        return self._gather(state.t().index_select(1, self._perm))

    # ------------------------------------------------------- batch split
    @staticmethod
    def _share(nodes) -> np.ndarray:
        """This rank's :func:`share` of a batch (``[S]`` or ``[S, ...]``)
        under rules that bind ``"batch"``, in
        :func:`~repro_torch.shardlib.axis_index` order.  The whole batch
        without a split."""
        nodes = np.asarray(nodes)
        axes = sl._live_axes("batch")
        if not axes:
            return nodes
        return share(nodes, sl.axis_size(axes), sl.axis_index(axes))

    @staticmethod
    def _gather(rows: torch.Tensor) -> np.ndarray:
        """Every rank's ``rows`` (a share's ``[S_r, ...]`` answer) on
        the host, in rank order: the padded batch's ``[S_pad, ...]``
        (callers cut it to the batch).  ``rows`` itself without a
        split."""
        return sl.all_gather(rows, sl._live_axes("batch"), axis=0) \
            .cpu().numpy()

    def _agree(self, flag: bool, every: bool) -> bool:
        """A sweep's decision over the whole batch: ``flag`` AND-ed
        (``every``) or OR-ed over the ranks of the split, so that each
        rank reads the levels the unsharded engine reads."""
        axes = sl._live_axes("batch")
        if not axes:
            return flag
        t = torch.tensor([int(flag)], dtype=torch.int32, device=self.device)
        return bool((sl.pmin if every else sl.pmax)(t, axes).item())

    def _perm_ids(self, nodes) -> np.ndarray:
        return self.index.perm[np.asarray(nodes, dtype=np.int32)]

    # ---------------------------------------------------------------- public
    def ssd(self, sources: np.ndarray) -> np.ndarray:
        """Distances from each source to every node, original node order."""
        s = len(sources)
        dist = self._ssd_dev(self._perm_ids(self._share(sources)))
        with span_if(self.tracer, "phase.to_host", what="dist"):
            return self._to_host(dist)[:s]

    def sssp(self, sources: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(dist, pred): pred[v] = node preceding v on a shortest path, -1
        for sources/unreachable. Node ids in original order."""
        s = len(sources)
        dist, pred = self._sssp_dev(self._perm_ids(self._share(sources)))
        with span_if(self.tracer, "phase.to_host", what="dist"):
            dist = self._to_host(dist)[:s]
        with span_if(self.tracer, "phase.to_host", what="pred"):
            return dist, self._to_host(pred)[:s]

    def p2p(self, sources: np.ndarray, targets: np.ndarray) -> np.ndarray:
        """Point-to-point distances ``dist(sources[i], targets[i])``
        (meet-in-the-middle, DESIGN.md §7) — a ``[S]`` float32 vector:
        forward labels of ``s`` (forward sweep + core search) meet
        backward labels of ``t`` (``plan_b`` in ascending rank with the
        reversed level body), ``dist(s, t) = min_m fwd[m] + bwd[m]``."""
        s = len(sources)
        fwd = self._forward_core(self._perm_ids(self._share(sources)))
        bwd = self._run_plan(
            self._init_state(self._perm_ids(self._share(targets))),
            self._levels_b, self._relax_level_rev, reverse=True)
        return self._gather((fwd + bwd).amin(dim=0))[:s]

    def ssd_within(self, sources: np.ndarray, d: float) -> np.ndarray:
        """Distance-threshold query (DESIGN.md §7): distances from each
        source in original node order, with every entry beyond ``d``
        masked to ``+inf`` — nodes within the threshold carry exactly
        their SSD distance."""
        d = float(np.float32(d))
        s = len(sources)
        dist = self._forward_core(self._perm_ids(self._share(sources)), d)
        dist.masked_fill_(~(dist <= d), INF)            # mask core output
        return self._to_host(self._relax_sweep(dist, self._sweep_b, d))[:s]

    def knn(self, sources: np.ndarray, k: int
            ) -> Tuple[np.ndarray, np.ndarray]:
        """The ``k`` nearest nodes of each source (DESIGN.md §7):
        ``(nodes, dist)``, each ``[S, k]``, ascending by ``(distance,
        node id)`` with the source itself included at distance 0; rows
        with fewer than ``k`` reachable nodes pad with ``(-1, +inf)``."""
        if not 1 <= k <= self.index.n:
            raise ValueError(f"k must be in [1, {self.index.n}], got {k}")
        return _knn_select(self.ssd(sources), k)

    def paths(self, sources: np.ndarray, targets: np.ndarray) -> list:
        """Unfold predecessors into explicit node paths (one per source)."""
        dist, pred = self.sssp(sources)
        out = []
        for i, t in enumerate(np.asarray(targets).tolist()):
            if not np.isfinite(dist[i, t]):
                out.append(None)
                continue
            path = [t]
            guard = 0
            while pred[i, path[-1]] >= 0 and guard <= self.index.n:
                path.append(int(pred[i, path[-1]]))
                guard += 1
            out.append(path[::-1])
        return out

    # ----------------------------------------------- paper-faithful Dijkstra
    def _core_dijkstra_host(self, dist: np.ndarray) -> np.ndarray:
        """Host heap Dijkstra on the core CSR for every batch row — the
        literal §5.2 in-memory core search.  Mutates and returns the
        writable ``[S, n_pad]`` host array (a transposed view will do)."""
        ix = self.index
        lo, c = ix.n_noncore, ix.n_core
        for i in range(dist.shape[0]):
            dc = dist[i, lo:lo + c].copy()
            heap = [(float(d), int(v)) for v, d in enumerate(dc)
                    if np.isfinite(d)]
            heapq.heapify(heap)
            done = np.zeros(c, dtype=bool)
            while heap:
                d_u, u = heapq.heappop(heap)
                if done[u] or d_u > dc[u]:
                    continue
                done[u] = True
                e0, e1 = ix.core_ptr[u], ix.core_ptr[u + 1]
                for v, wv in zip(ix.core_dst[e0:e1], ix.core_w[e0:e1]):
                    nd = d_u + float(wv)
                    if nd < dc[v]:
                        dc[v] = nd
                        heapq.heappush(heap, (nd, int(v)))
            dist[i, lo:lo + c] = dc
        return dist


def dijkstra_reference(g, sources) -> np.ndarray:
    """Plain in-memory Dijkstra oracle on the *original* graph."""
    n = g.n
    out = np.full((len(sources), n), np.inf, dtype=np.float64)
    for i, s in enumerate(np.asarray(sources).tolist()):
        dist = out[i]
        dist[s] = 0.0
        heap = [(0.0, s)]
        while heap:
            d_u, u = heapq.heappop(heap)
            if d_u > dist[u]:
                continue
            dsts, ws = g.out_edges(u)
            for v, wv in zip(dsts.tolist(), ws.tolist()):
                nd = d_u + wv
                if nd < dist[v]:
                    dist[v] = nd
                    heapq.heappush(heap, (nd, v))
    return out
