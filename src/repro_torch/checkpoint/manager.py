"""Async, restart-safe checkpointing, on the JAX package's on-disk layout,
whole or by blocks over a mesh.

Layout per step: ``<dir>/step_<n>/`` holding one ``.npy`` per tree leaf
(keyed by its path: ``params/layers/0/wq``, ``opt/m/...``,
``opt/count``; the file name is the key with ``/`` as ``__``) and
``manifest.json``, which records each leaf's key, file, shape, dtype and
CRC-32 of its bytes, and an ``extra`` dict (the step).  Writes go to
``step_<n>.tmp`` and are atomically renamed, so a crash mid-write never
corrupts the latest checkpoint, and a restart picks the newest
*complete* step.  Async mode copies the tensors to the host on the
caller's thread and writes on a writer thread.

The bytes are the JAX package's (``src/repro/checkpoint/manager.py``):
leaves in its order, the same ``.npy`` headers (a bf16 leaf is saved as
2-byte void, as numpy saves ``ml_dtypes.bfloat16``, and its manifest
dtype is ``bfloat16``), so each package restores the other's
checkpoints.  This module needs no ``ml_dtypes``.

**On a mesh** (``shardings``: a tree of ``NamedSharding`` shaped like
the tree, such as a cell's ``in_shardings[0]``; matched to the leaves by
path) the files are the same whole leaves and the same manifest, with
each whole leaf's CRC-32, so either package's ``load_pytree`` reads
them, and a checkpoint written on one mesh restores onto any mesh whose
axes divide its shapes (the elastic re-cut).  Who does what:

* save: each rank writes only its own block into each leaf's file, at
  the block's offsets (rows, or strided runs for a cut of a later dim;
  the header is written by hand, as :func:`_save_npy` does).  A block
  that several ranks hold (a replicated leaf, an FSDP leaf on a ``(1,
  N)`` mesh) is written by one of them: the rank at index 0 on the mesh
  axes that do not cut the leaf.  Then the whole-leaf CRCs, split over
  the ranks (the largest leaves first, each to the rank with the fewest
  bytes so far), are read back from the files in chunks, and the rank at
  mesh index 0 writes the manifest, renames ``step_<n>.tmp`` and
  collects old steps.  A step directory thus appears only when every
  rank's blocks, every CRC and the manifest are on disk: a rank that
  fails mid-write leaves the previous step the latest, and every rank
  raises.
* restore: a rank reads only its blocks (``np.load(mmap_mode="r")``, a
  slice, a copy): ``shardlib.local_block`` of the whole leaf, bit for
  bit, without holding the whole leaf.  With ``verify`` each rank
  checks the CRCs of its share of the leaves, streamed; one all-reduce
  agrees on the outcome, and on a mismatch every rank raises
  ``IOError``.  Every rank restores the same step: without one named,
  the latest that the rank at mesh index 0 sees.

The collectives run over the mesh's group (``shardlib.mesh_group``) and
only on the caller's thread: in :meth:`CheckpointManager.save` (the
``.tmp`` directory made and agreed) and in ``wait`` (the writes agreed,
the CRCs, the rename), never on the writer thread, whose work is file
I/O alone.  So they never interleave with a train step's collectives on
the same group.  An async sharded save's step appears at the next
``wait`` (called by the next ``save`` or ``restore``, or by the caller).
The steps' directory must be one filesystem that every rank sees.
"""
from __future__ import annotations

import dataclasses
import io
import json
import math
import os
import shutil
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import shardlib as sl
from ..tree import flatten_with_paths, leaves, unflatten

_BF16 = "bfloat16"
#: Bytes a CRC's read takes at a time, and a write.
_CHUNK, _IO_CHUNK = 1 << 22, 1 << 30
#: A CRC of more than twice this many bytes is split over threads.
_CRC_PIECE, _CRC_THREADS = 1 << 26, min(8, os.cpu_count() or 1)


@dataclasses.dataclass
class _Host:
    """A leaf in host memory as the JAX package saves it (bf16 as 2-byte
    void holding the same bits), and its manifest dtype name."""
    array: np.ndarray
    dtype: str


def _host(leaf, copy: bool = False) -> _Host:
    """``copy``: never share memory with ``leaf`` (a card's tensor is
    copied by the move to the host already)."""
    if isinstance(leaf, _Host):
        return leaf
    if isinstance(leaf, torch.Tensor):
        copy = copy and leaf.device.type == "cpu"
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            arr, name = t.view(torch.int16).numpy().view("V2"), _BF16
        else:
            arr = t.numpy()
            name = str(arr.dtype)
    else:
        arr = np.asarray(leaf)
        name = str(arr.dtype)
    return _Host(np.array(arr, copy=True) if copy else arr, name)


def _crc(arr: np.ndarray) -> int:
    """CRC-32 of ``arr``'s bytes in C order (``arr.tobytes()``'s)."""
    data = memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
    return _crc_pieces(len(data), lambda lo, hi: zlib.crc32(data[lo:hi]))


def _crc_pieces(n: int, piece_crc) -> int:
    """CRC-32 of ``n`` bytes from ``piece_crc(lo, hi)``, the CRC of bytes
    ``[lo, hi)``: pieces of at least ``_CRC_PIECE`` bytes on threads
    (zlib leaves the interpreter lock), joined by
    :func:`_crc32_combine`."""
    k = max(1, min(_CRC_THREADS, n // _CRC_PIECE))
    if k == 1:
        return piece_crc(0, n) & 0xFFFFFFFF
    bounds = [n * i // k for i in range(k + 1)]
    with ThreadPoolExecutor(k) as pool:
        crcs = list(pool.map(piece_crc, bounds[:-1], bounds[1:]))
    crc = crcs[0]
    for c, lo, hi in zip(crcs[1:], bounds[1:-1], bounds[2:]):
        crc = _crc32_combine(crc, c, hi - lo)
    return crc & 0xFFFFFFFF


def _gf2_times(mat: List[int], vec: int) -> int:
    out, i = 0, 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _gf2_square(mat: List[int]) -> List[int]:
    return [_gf2_times(mat, m) for m in mat]


def _crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """The CRC-32 of ``a + b`` from ``crc32(a)``, ``crc32(b)`` and
    ``len(b)`` (zlib's ``crc32_combine``: ``len2`` zero bytes appended to
    ``a`` by squaring the CRC's shift operator over GF(2))."""
    if len2 <= 0:
        return crc1
    odd = [0xEDB88320] + [1 << n for n in range(31)]    # one zero bit
    even = _gf2_square(odd)                             # two
    odd = _gf2_square(even)                             # four
    while True:
        even = _gf2_square(odd)
        if len2 & 1:
            crc1 = _gf2_times(even, crc1)
        len2 >>= 1
        if not len2:
            break
        odd = _gf2_square(even)
        if len2 & 1:
            crc1 = _gf2_times(odd, crc1)
        len2 >>= 1
        if not len2:
            break
    return crc1 ^ crc2


def _save_npy(path: str, arr: np.ndarray, dtype: str) -> None:
    """``np.save``, but a bf16 leaf's header says ``<V2``, as numpy writes
    for ``ml_dtypes.bfloat16`` (a plain 2-byte void would say ``|V2``)."""
    if dtype != _BF16:
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def save_pytree(tree, directory: str, extra: Optional[Dict] = None,
                shardings=None) -> None:
    """Write ``tree`` (of tensors or numpy arrays) under ``directory``,
    via ``directory.tmp`` and a rename.  With ``shardings`` ``tree``
    holds this rank's blocks, and every rank of their mesh calls this:
    each writes its own blocks of the whole leaves (the module's
    docstring)."""
    if shardings is not None:
        job = _ShardedSave(tree, shardings, directory, extra or {})
        error = None
        try:
            job.write()
        except Exception as e:          # agreed, then raised, in finish
            error = e
        job.finish(error)
        return
    tmp = directory + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"leaves": [], "extra": extra or {}}
    for key, leaf in flatten_with_paths(tree):
        h = _host(leaf)
        fname = key.replace("/", "__") + ".npy"
        _save_npy(os.path.join(tmp, fname), h.array, h.dtype)
        manifest["leaves"].append({
            "key": key, "file": fname, "shape": list(h.array.shape),
            "dtype": h.dtype, "crc": _crc(h.array)})
    _write_manifest(tmp, manifest)
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.rename(tmp, directory)


def _write_manifest(tmp: str, manifest: Dict) -> None:
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def _from_file(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def load_pytree(directory: str, like, device=None, verify: bool = True,
                shardings=None, into: bool = False):
    """Restore into the structure of ``like`` (a tree of anything: tensors,
    arrays or the specs :meth:`CheckpointManager.peek` gives) as CPU
    tensors, or on ``device``.  Raises ``IOError`` on a CRC mismatch.
    With ``shardings`` every rank of their mesh calls this and gets its
    own blocks (the module's docstring); a leaf with no sharding comes
    back whole.  ``into``: ``like``'s leaves are tensors of the shapes
    read (the blocks, with ``shardings``) and dtypes saved, and each is
    filled in place (a cell's undrawn state: no second copy of it).
    Returns (tree, extra)."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {rec["key"]: rec for rec in manifest["leaves"]}
    if shardings is not None:
        return (_load_blocks(directory, like, by_key, device, verify,
                             shardings, into), manifest["extra"])
    out = []
    for key, dst in flatten_with_paths(like):
        rec = by_key[key]
        arr = np.load(os.path.join(directory, rec["file"]))
        if verify and _crc(arr) != rec["crc"]:
            raise IOError(f"checksum mismatch for {key}")
        out.append(_placed(_from_file(arr, rec["dtype"]), key, device,
                           dst if into else None))
    return unflatten(like, out), manifest["extra"]


def _placed(t: torch.Tensor, key: str, device, dst=None) -> torch.Tensor:
    """``t`` read from a file: on ``device`` (or the host), or copied
    into ``dst`` in place."""
    if dst is None:
        return t if device is None else t.to(device)
    if (dst.shape, dst.dtype) != (t.shape, t.dtype):
        raise ValueError(f"{key}: {tuple(t.shape)} {t.dtype} read, restored "
                         f"into {tuple(dst.shape)} {dst.dtype}")
    return dst.copy_(t)


# ---------------------------------------------------------------------------
# blocks over a mesh
# ---------------------------------------------------------------------------

def _mesh_of(shardings):
    meshes = {id(s.mesh): s.mesh for s in leaves(shardings)}
    if len(meshes) != 1:
        raise ValueError(f"shardings over {len(meshes)} meshes; a "
                         "checkpoint's blocks lie on one")
    return next(iter(meshes.values()))


def _all_reduce(values: List[int], mesh, op) -> List[int]:
    """``values`` reduced over every rank of ``mesh`` (caller's thread)."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device("cpu"))
    t = torch.tensor(values, dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=op, group=sl.mesh_group(mesh))
    return t.tolist()


def _axes(part) -> Tuple[str, ...]:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def _spec(shardings_by_key: Dict, key: str):
    s = shardings_by_key.get(key)
    return sl.P() if s is None else s.spec


def _itemsize(dtype: str) -> int:
    return 2 if dtype == _BF16 else np.dtype(dtype).itemsize


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return _BF16
        return str(torch.empty(0, dtype=leaf.dtype).numpy().dtype)
    return str(np.asarray(leaf).dtype)


def _npy_header(shape, dtype: str) -> bytes:
    """The header ``np.save`` (or :func:`_save_npy`, for bf16) writes
    for a C-ordered array of ``shape``."""
    descr = "<V2" if dtype == _BF16 else \
        np.lib.format.dtype_to_descr(np.dtype(dtype))
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(
        buf, {"descr": descr, "fortran_order": False, "shape": tuple(shape)})
    return buf.getvalue()


def _runs(shape, block: Tuple[slice, ...], itemsize: int):
    """(offset in the leaf's data, offset in the block, length), in
    bytes, of each contiguous run of a C-ordered block: the dims after
    its last cut one are whole, so each run spans them."""
    if not shape:
        yield 0, 0, itemsize
        return
    bshape = [s.stop - s.start for s in block]
    cut = [d for d, n in enumerate(shape) if bshape[d] != n]
    k = cut[-1] if cut else 0
    stride = np.cumprod((list(shape[1:]) + [1])[::-1])[::-1].astype(np.int64)
    run = math.prod(bshape[k:]) * itemsize
    if k:
        outer = np.indices(bshape[:k], dtype=np.int64).reshape(k, -1).T
        offs = (outer + [s.start for s in block[:k]]) @ stride[:k]
    else:
        offs = np.zeros(1, np.int64)
    offs = (offs + block[k].start * stride[k]) * itemsize
    for i, off in enumerate(offs.tolist()):
        yield off, i * run, run


def _pwrite_all(fd: int, data: memoryview, offset: int) -> None:
    while data:
        n = os.pwrite(fd, data[:_IO_CHUNK], offset)
        data, offset = data[n:], offset + n


def _file_crc(path: str) -> int:
    """CRC-32 of a ``.npy`` file's data, read in chunks of ``_CHUNK`` (a
    buffer a thread: :func:`_crc_pieces`)."""
    with open(path, "rb") as f:
        major, _ = np.lib.format.read_magic(f)
        if major == 1:
            np.lib.format.read_array_header_1_0(f)
        else:
            np.lib.format.read_array_header_2_0(f)
        start, fd = f.tell(), f.fileno()

        def piece(lo: int, hi: int) -> int:
            buf = memoryview(bytearray(min(_CHUNK, hi - lo)))
            crc = 0
            while lo < hi:
                n = os.preadv(fd, [buf[:min(_CHUNK, hi - lo)]], start + lo)
                if n == 0:
                    raise IOError(f"{path} ends {hi - lo} bytes early")
                crc = zlib.crc32(buf[:n], crc)
                lo += n
            return crc
        return _crc_pieces(os.fstat(fd).st_size - start, piece)


def _crc_owners(sizes: List[int], n_ranks: int) -> List[int]:
    """The rank that checks each leaf's CRC: the largest leaves first,
    each to the rank with the fewest bytes so far."""
    load, owner = [0] * n_ranks, [0] * len(sizes)
    for i in sorted(range(len(sizes)), key=lambda i: (-sizes[i], i)):
        r = min(range(n_ranks), key=lambda r: (load[r], r))
        owner[i] = r
        load[r] += sizes[i]
    return owner


@dataclasses.dataclass
class _Leaf:
    """One leaf of a sharded save: the whole leaf's shape and dtype,
    this rank's block in it, and the block on the host where this rank
    writes it."""
    key: str
    file: str
    shape: Tuple[int, ...]
    dtype: str
    block: Tuple[slice, ...]
    host: Optional[np.ndarray]

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * _itemsize(self.dtype)


class _ShardedSave:
    """One sharded save: planned on the caller's thread (the host copies
    of the blocks this rank writes; ``.tmp`` made by the rank at mesh
    index 0 and agreed), :meth:`write` (file I/O only, any thread), then
    :meth:`finish` on the caller's thread."""

    def __init__(self, tree, shardings, directory: str, extra: Dict):
        self.mesh = mesh = _mesh_of(shardings)
        self.directory, self.tmp, self.extra = (directory,
                                                directory + ".tmp", extra)
        self.lead = sl.mesh_index(mesh) == 0
        names = tuple(mesh.mesh_dim_names)
        coord = mesh.get_coordinate()
        by_key = dict(flatten_with_paths(shardings))
        self.leaves: List[_Leaf] = []
        for key, leaf in flatten_with_paths(tree):
            spec = _spec(by_key, key)
            shape = list(leaf.shape)
            for d, part in enumerate(tuple(spec)):
                shape[d] *= sl.axis_size(_axes(part), mesh)
            cut = sl.spec_axes(spec, mesh)
            writes = all(c == 0 for n, c in zip(names, coord)
                         if n not in cut)
            self.leaves.append(_Leaf(
                key, key.replace("/", "__") + ".npy", tuple(shape),
                _dtype_name(leaf), sl.block_slices(shape, spec, mesh),
                _host(leaf, copy=True).array if writes else None))
        error = None
        if self.lead:
            try:
                if os.path.exists(self.tmp):
                    shutil.rmtree(self.tmp)
                os.makedirs(self.tmp)
            except OSError as e:
                error = e
        self._agree(error, f"could not make {self.tmp}")

    def _agree(self, error: Optional[BaseException], what: str) -> None:
        """Raise on every rank if any rank failed (the failing rank its
        own error); the lead removes ``.tmp``."""
        if _all_reduce([int(error is not None)], self.mesh,
                       dist.ReduceOp.MAX)[0]:
            self._fail(error, what)

    def _fail(self, error: Optional[BaseException], what: str) -> None:
        if self.lead:
            shutil.rmtree(self.tmp, ignore_errors=True)
        if error is not None:
            raise error
        raise IOError(f"checkpoint {self.directory}: {what} on another "
                      "rank")

    def write(self) -> None:
        """Write this rank's blocks at their offsets in the leaf files."""
        for leaf in self.leaves:
            if leaf.host is None:
                continue
            header = _npy_header(leaf.shape, leaf.dtype)
            raw = np.ascontiguousarray(leaf.host).reshape(-1).view(np.uint8)
            fd = os.open(os.path.join(self.tmp, leaf.file),
                         os.O_WRONLY | os.O_CREAT, 0o666)
            try:
                _pwrite_all(fd, memoryview(header), 0)
                for off, lo, n in _runs(leaf.shape, leaf.block,
                                        _itemsize(leaf.dtype)):
                    _pwrite_all(fd, memoryview(raw[lo:lo + n]),
                                len(header) + off)
            finally:
                os.close(fd)
            leaf.host = None

    def finish(self, error: Optional[BaseException]) -> None:
        """Agree that every rank wrote its blocks, take the CRCs (each
        rank its share), then the lead writes the manifest and renames
        ``.tmp``; raises on every rank if any of it failed."""
        self._agree(error, "a write failed")
        owner = _crc_owners([leaf.nbytes for leaf in self.leaves],
                            self.mesh.size())
        me, crcs, error = sl.mesh_index(self.mesh), [], None
        for leaf, who in zip(self.leaves, owner):
            crc = 0
            if who == me and error is None:
                try:
                    crc = _file_crc(os.path.join(self.tmp, leaf.file))
                except OSError as e:
                    error = e
            crcs.append(crc)
        # each CRC comes from one rank: the sum is it; the last slot
        # counts the ranks whose reads failed
        *crcs, failed = _all_reduce(crcs + [int(error is not None)],
                                    self.mesh, dist.ReduceOp.SUM)
        if failed:
            self._fail(error, "a CRC read failed")
        if self.lead:
            try:
                _write_manifest(self.tmp, {"leaves": [
                    {"key": leaf.key, "file": leaf.file,
                     "shape": list(leaf.shape), "dtype": leaf.dtype,
                     "crc": crc} for leaf, crc in zip(self.leaves, crcs)],
                    "extra": self.extra})
                if os.path.exists(self.directory):
                    shutil.rmtree(self.directory)
                os.rename(self.tmp, self.directory)
            except OSError as e:
                error = e
        self._agree(error, "the manifest or the rename failed")


def _load_blocks(directory: str, like, by_key: Dict, device, verify: bool,
                 shardings, into: bool = False):
    """This rank's blocks of ``like``'s leaves (``load_pytree`` with
    ``shardings``)."""
    mesh = _mesh_of(shardings)
    specs = dict(flatten_with_paths(shardings))
    flat = flatten_with_paths(like)
    keys = [key for key, _ in flat]
    recs = [by_key[key] for key in keys]
    bad = [0] * len(recs)
    error = None
    if verify:
        owner = _crc_owners([math.prod(r["shape"]) * _itemsize(r["dtype"])
                             for r in recs], mesh.size())
        me = sl.mesh_index(mesh)
        for i, rec in enumerate(recs):
            if owner[i] == me:
                try:
                    path = os.path.join(directory, rec["file"])
                    bad[i] = int(_file_crc(path) != rec["crc"])
                except OSError:
                    bad[i] = 1
    out = []
    try:
        for (key, dst), rec in zip(flat, recs):
            arr = np.load(os.path.join(directory, rec["file"]),
                          mmap_mode="r")
            block = np.array(arr[sl.block_slices(arr.shape,
                                                 _spec(specs, key), mesh)])
            del arr
            out.append(_placed(_from_file(block, rec["dtype"]), key, device,
                               dst if into else None))
    except (OSError, ValueError) as e:
        error = e
    agreed = _all_reduce(bad + [int(error is not None)], mesh,
                         dist.ReduceOp.MAX)
    if any(agreed[:-1]):
        raise IOError("checksum mismatch for " + ", ".join(
            k for k, b in zip(keys, agreed) if b))
    if error is not None:
        raise error
    if agreed[-1]:
        raise IOError(f"checkpoint {directory}: a block read failed on "
                      "another rank")
    return unflatten(like, out)


@dataclasses.dataclass
class CheckpointManager:
    """Steps under ``directory``, the newest ``keep_last`` kept.  With
    ``shardings`` (:meth:`save`, :meth:`restore`) every rank of their
    mesh makes the same calls, and ``directory`` is one filesystem every
    rank sees."""
    directory: str
    keep_last: int = 3
    async_write: bool = True

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending: Optional[_ShardedSave] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, extra: Optional[Dict] = None,
             shardings=None) -> None:
        """Checkpoint ``tree`` as step ``step``.  With ``shardings``
        ``tree`` holds this rank's blocks; the step lands at the next
        :meth:`wait` (at once without ``async_write``)."""
        self.wait()
        extra = dict(extra or {})
        extra["step"] = step
        target = self.step_dir(step)
        if shardings is not None:
            self._pending = job = _ShardedSave(tree, shardings, target,
                                               extra)
            write = job.write
        else:
            # the device->host copy on the caller's thread (the tensors
            # may change in place after this returns); serialization on
            # the writer thread
            host_tree = unflatten(tree, [
                _host(leaf, copy=True)
                for _, leaf in flatten_with_paths(tree)])

            def write():
                save_pytree(host_tree, target, extra)
                self._gc()

        def work():
            try:
                write()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        if self.async_write:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self.wait()

    def wait(self) -> None:
        """Join the writer; a sharded save then finishes here, on the
        caller's thread (every rank of its mesh calls this)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        job, self._pending = self._pending, None
        if job is not None:
            error, self._error = self._error, None
            job.finish(error)
            if job.lead:
                self._gc()
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        for s in self.all_steps()[: -self.keep_last]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, name,
                                               "manifest.json")):
                    out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self, mesh=None) -> Optional[int]:
        """The newest complete step (None without one); with ``mesh``,
        the one the rank at its index 0 sees, on every rank of it."""
        steps = self.all_steps()
        mine = steps[-1] if steps else None
        if mesh is None:
            return mine
        lead = sl.mesh_index(mesh) == 0
        got = _all_reduce([mine + 1 if lead and mine is not None else 0],
                          mesh, dist.ReduceOp.SUM)[0]
        return got - 1 if got else None

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def restore(self, like, step: Optional[int] = None, device=None,
                shardings=None, into: bool = False):
        """(tree shaped like ``like``, extra) of ``step`` (default the
        latest), as CPU tensors or on ``device``; with ``shardings``
        this rank's blocks, the step agreed over their mesh; ``into``:
        read into ``like``'s tensors in place (``load_pytree``)."""
        self.wait()
        if step is None:
            step = self.latest_step(None if shardings is None
                                    else _mesh_of(shardings))
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return load_pytree(self.step_dir(step), like, device,
                           shardings=shardings, into=into)

    def peek(self, step: Optional[int] = None):
        """(a tree of ``LeafSpec`` rebuilt from the manifest alone, extra):
        the template to restore into when no state survives.  Digit keys
        become lists, other keys dicts (an ``OptState`` comes back as a
        dict of ``m``, ``v`` and ``count``)."""
        step = step if step is not None else self.latest_step()
        with open(os.path.join(self.step_dir(step), "manifest.json")) as f:
            manifest = json.load(f)
        flat = {rec["key"]: LeafSpec(tuple(rec["shape"]), rec["dtype"])
                for rec in manifest["leaves"]}
        return _unflatten_paths(flat), manifest["extra"]


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """A leaf's shape and dtype name, as a manifest records them."""
    shape: tuple
    dtype: str


def _unflatten_paths(flat: Dict[str, Any]):
    """Inverse of the path flattening for dict/list trees."""
    root: Dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        cur = root
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = val
    return _listify(root)


def _listify(node):
    if not isinstance(node, dict):
        return node
    keys = list(node.keys())
    if keys and all(k.isdigit() for k in keys):
        return [_listify(node[str(i)]) for i in range(len(keys))]
    return {k: _listify(v) for k, v in node.items()}
