"""Async, restart-safe checkpointing, on the JAX package's on-disk layout.

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
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import zlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..tree import flatten_with_paths, unflatten

_BF16 = "bfloat16"


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
    return zlib.crc32(arr.tobytes()) & 0xFFFFFFFF


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


def save_pytree(tree, directory: str, extra: Optional[Dict] = None) -> None:
    """Write ``tree`` (of tensors or numpy arrays) under ``directory``,
    via ``directory.tmp`` and a rename."""
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
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.rename(tmp, directory)


def _from_file(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def load_pytree(directory: str, like, device=None, verify: bool = True):
    """Restore into the structure of ``like`` (a tree of anything: tensors,
    arrays or the specs :meth:`CheckpointManager.peek` gives) as CPU
    tensors, or on ``device``.  Raises ``IOError`` on a CRC mismatch.
    Returns (tree, extra)."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {rec["key"]: rec for rec in manifest["leaves"]}
    out = []
    for key, _ in flatten_with_paths(like):
        rec = by_key[key]
        arr = np.load(os.path.join(directory, rec["file"]))
        if verify and _crc(arr) != rec["crc"]:
            raise IOError(f"checksum mismatch for {key}")
        t = _from_file(arr, rec["dtype"])
        out.append(t if device is None else t.to(device))
    return unflatten(like, out), manifest["extra"]


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep_last: int = 3
    async_write: bool = True

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, extra: Optional[Dict] = None) -> None:
        self.wait()
        extra = dict(extra or {})
        extra["step"] = step
        # the device->host copy on the caller's thread (the tensors may
        # change in place after this returns); serialization on the
        # writer thread
        host_tree = unflatten(tree, [_host(leaf, copy=True)
                                     for _, leaf in flatten_with_paths(tree)])
        target = os.path.join(self.directory, f"step_{step:08d}")

        def work():
            try:
                save_pytree(host_tree, target, extra)
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        if self.async_write:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self._raise_if_failed()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
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

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def restore(self, like, step: Optional[int] = None, device=None):
        """(tree shaped like ``like``, extra) of ``step`` (default the
        latest), as CPU tensors or on ``device``."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return load_pytree(self.step_dir(step), like, device)

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
