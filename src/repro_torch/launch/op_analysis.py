"""Work counts of an eager step from the ops it dispatches: the
counterpart of ``src/repro/launch/hlo_analysis.py``, which reads them
from the post-SPMD HLO text of a compiled JAX cell.

:class:`OpAnalysis` is a ``TorchDispatchMode``: every aten op and every
``c10d`` collective the step dispatches passes through it, on fake
tensors (the dry run, :mod:`repro_torch.launch.dryrun`) or on real ones.
Eager runs every loop trip, so counting each op as it runs is what
``hlo_analysis`` gets by multiplying a while body by its trip count.
Its :meth:`~OpAnalysis.report` has ``hlo_analysis.analyze``'s keys:

* ``flops``: matmul-type ops by ``torch.utils.flop_counter``'s formulas
  (2·|result|·K; ``matmul_flops`` alone), elementwise ops and
  reductions |result| (``hlo_analysis.py``'s reading of them), and the
  hand-written kernels' operations; by dtype in ``flops_by_dtype``.
* ``bytes``: operands plus result of each op that moves data.  This is
  eager's own traffic, one kernel an op with no fusion boundary, so it
  is larger than a fused program's.  Views, empty allocations and
  scalar reads move nothing; a gather moves its index and twice its
  result (rows read, rows written), a scatter its index and three times
  its updates (read, and the rows they land on read and written), plus
  its result where it is not in place.  ``bytes_by_class`` splits them
  into ``hlo_analysis.BYTE_CLASSES``.
* ``collectives``: the bytes this rank sends, by the five kinds of
  ``hlo_analysis.COLLECTIVES`` (an all-reduce's or all-gather's input);
  ``collective_bytes`` their sum.  The port's ``psum_scatter`` is an
  all-reduce and a chunk, and counts as the all-reduce it is.
* ``kernels``: calls, operations and bytes of each hand-written kernel
  whose fake form ran (``repro_torch.kernels.FAKE_LISTENERS``), by its
  ``launch_counters()`` name; they count in the totals too
  (``flash_decode`` under "dot", the bag sums under "gather_scatter").

:class:`LiveBytes` follows every storage the step allocates, from its
creation to its free (a ``weakref.finalize`` on the storage, whose
Python object lives as long as the storage does): the argument, output
and temp bytes of the step at its peak, XLA's ``memory_analysis``.
"""
from __future__ import annotations

import threading
import weakref
from typing import Any, Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from .. import kernels

__all__ = ["COLLECTIVES", "BYTE_CLASSES", "OpAnalysis", "LiveBytes",
           "analyze", "storage_bytes"]

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
BYTE_CLASSES = ("dot", "elementwise", "gather_scatter", "copy_layout",
                "collective", "other")

#: The c10d ops of torch.distributed's calls of the five kinds, and the
#: argument that holds what this rank sends.
_C10D = {
    "allreduce_": ("all-reduce", 0), "allreduce_coalesced_": ("all-reduce", 0),
    "allgather_": ("all-gather", 1), "_allgather_base_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "alltoall_": ("all-to-all", 1), "alltoall_base_": ("all-to-all", 1),
    "send": ("collective-permute", 0),
}

#: Ops that move no data (views aside): allocations left empty, a view
#: of a fresh result, scalar reads, metadata.
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "_unsafe_view", "_local_scalar_dense",
               "set_", "resize_", "is_same_size"}
_GATHERS = {"embedding", "index_select", "gather", "index", "take",
            "masked_select"}
_SCATTERS = {"index_add", "index_add_", "index_put", "index_put_",
             "_index_put_impl_", "scatter", "scatter_", "scatter_add",
             "scatter_add_", "scatter_reduce", "scatter_reduce_",
             "index_copy", "index_copy_", "embedding_dense_backward",
             "index_fill", "index_fill_", "masked_scatter", "masked_scatter_"}
#: Copies (some tagged pointwise): no FLOPs, hlo_analysis's copy class.
_LAYOUT = {"copy_", "clone", "_to_copy", "cat", "stack", "constant_pad_nd",
           "flip", "roll", "repeat", "expand_copy", "permute_copy",
           "_unsafe_index", "unfold_copy", "split_with_sizes_copy"}
#: Fills, tagged pointwise or not: no FLOPs (hlo_analysis's broadcast).
_FILLS = {"fill", "fill_", "zero_", "zeros", "ones", "full", "zeros_like",
          "ones_like", "full_like", "new_zeros", "new_ones", "new_full",
          "scalar_tensor", "arange"}
#: Not tagged pointwise or reduction, but read as hlo_analysis reads a
#: reduce: |result| FLOPs.
_REDUCING = {"_softmax", "_log_softmax", "_softmax_backward_data",
             "_log_softmax_backward_data", "logsumexp", "cumsum", "cumprod",
             "native_layer_norm", "native_layer_norm_backward"}
_KERNEL_CLASS = {"flash_decode": "dot", "embedding_bag": "gather_scatter",
                 "bag_sum_backward": "gather_scatter"}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(ts: Iterable[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _is_index(t: torch.Tensor) -> bool:
    return not (t.is_floating_point() or t.is_complex()
                or t.dtype == torch.bool)


class OpAnalysis(TorchDispatchMode):
    """Counts of what runs under it (``with OpAnalysis() as oa: ...``,
    then ``oa.report()``); see the module's docstring."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.matmul_flops = 0.0
        self.flops_by_dtype: Dict[str, float] = {}
        self.by_class = {k: 0.0 for k in BYTE_CLASSES}
        self.coll = {k: 0.0 for k in COLLECTIVES}
        self.kernels: Dict[str, Dict[str, float]] = {}
        self._lock = threading.Lock()

    def __enter__(self):
        kernels.FAKE_LISTENERS.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        kernels.FAKE_LISTENERS.remove(self._kernel)
        return super().__exit__(*exc)

    def _add_flops(self, n: float, dtype: str) -> None:
        self.flops += n
        self.flops_by_dtype[dtype] = self.flops_by_dtype.get(dtype, 0.0) + n

    def _kernel(self, name: str, nbytes: float, ops: float, dtype) -> None:
        with self._lock:
            k = self.kernels.setdefault(
                name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
            k["launches"] += 1
            k["flops"] += ops
            k["bytes"] += nbytes
            self._add_flops(ops, str(dtype).replace("torch.", ""))
            self.by_class[_KERNEL_CLASS.get(name, "other")] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        with self._lock:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func.overloadpacket.__name__
        ns = func.namespace
        if ns == "c10d":
            if name in _C10D:
                kind, at = _C10D[name]
                sent = _nbytes(_tensors(args[at]))
                self.coll[kind] += sent
                self.by_class["collective"] += sent
            return
        if ns != "aten" or name in _NO_TRAFFIC or func.is_view:
            return
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if func.overloadpacket in flop_registry:
            # the formulas take shapes; an ``out_dtype`` (bmm.dtype) is
            # not one of them
            shaped = [a for a in args if not isinstance(a, torch.dtype)]
            n = float(flop_registry[func.overloadpacket](
                *shaped, **kwargs, out_val=out))
            self.matmul_flops += n
            self._add_flops(n, _dtype(ins[0]))
            self.by_class["dot"] += _nbytes(ins) + _nbytes(outs)
            return
        tags = func.tags
        if name in _LAYOUT:
            self.by_class["copy_layout"] += _nbytes(ins) + _nbytes(outs)
        elif name in _FILLS:
            self.by_class["other"] += _nbytes(ins) + _nbytes(outs)
        elif (torch.Tag.pointwise in tags or torch.Tag.reduction in tags
                or name in _REDUCING):
            if outs:    # in the operands' dtype (a compare's is not bool)
                self._add_flops(float(sum(t.numel() for t in outs)),
                                _dtype((ins or outs)[0]))
            self.by_class["elementwise"] += _nbytes(ins) + _nbytes(outs)
        elif name in _GATHERS:
            self.by_class["gather_scatter"] += (
                _nbytes(t for t in ins if _is_index(t)) + 2 * _nbytes(outs))
        elif name in _SCATTERS:
            idx = [t for t in ins[1:] if _is_index(t)]
            upd = [t for t in ins[1:] if not _is_index(t)]
            moved = (3 * _nbytes(upd) if upd else
                     3 * sum(t.numel() for t in idx) * ins[0].element_size())
            fresh = 0 if name.endswith("_") else _nbytes(outs)
            self.by_class["gather_scatter"] += _nbytes(idx) + moved + fresh
        else:
            self.by_class["other"] += _nbytes(ins) + _nbytes(outs)

    def report(self) -> Dict[str, Any]:
        """``hlo_analysis.analyze``'s keys, with ``matmul_flops``,
        ``flops_by_dtype`` and ``kernels``."""
        with self._lock:
            return {
                "flops": self.flops,
                "matmul_flops": self.matmul_flops,
                "flops_by_dtype": dict(self.flops_by_dtype),
                "bytes": float(sum(self.by_class.values())),
                "bytes_by_class": dict(self.by_class),
                "collectives": dict(self.coll),
                "collective_bytes": float(sum(self.coll.values())),
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
            }


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages of the tensors in ``tree``."""
    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


class LiveBytes(TorchDispatchMode):
    """The storages a step allocates, live at once at its peak.
    ``LiveBytes(args)`` takes the step's arguments (their storages are
    the argument bytes, held for the whole step); after the step,
    :meth:`finish` ``(result)`` gives ``argument_bytes``, ``output_bytes``
    (storages made by the step that its result holds) and
    ``temp_bytes`` (the peak of the step's own storages, less its
    output), so their sum is the step's peak of device memory."""

    def __init__(self, args):
        super().__init__()
        self._args = {t.untyped_storage()._cdata for t in _tensors(args)}
        self.argument_bytes = storage_bytes(args)
        self._live: Dict[int, int] = {}
        self._now = 0
        self.peak = 0
        self._lock = threading.Lock()

    def _free(self, key: int) -> None:
        with self._lock:
            self._now -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            with self._lock:
                if key in self._live or key in self._args:
                    continue
                self._live[key] = st.nbytes()
                self._now += self._live[key]
                self.peak = max(self.peak, self._now)
            weakref.finalize(st, self._free, key)
        return out

    def finish(self, result) -> Dict[str, int]:
        with self._lock:
            mine = {}
            for t in _tensors(result):
                st = t.untyped_storage()
                if st._cdata in self._live:
                    mine[st._cdata] = st.nbytes()
            out = sum(mine.values())
            return {"argument_bytes": self.argument_bytes,
                    "output_bytes": out, "temp_bytes": self.peak - out}


def analyze(fn, *args, **kwargs) -> Dict[str, Any]:
    """:meth:`OpAnalysis.report` of one call ``fn(*args, **kwargs)``."""
    with OpAnalysis() as oa:
        fn(*args, **kwargs)
    return oa.report()
