"""Crash-restart training loop and the survivors' mesh (the JAX
package's ``ft/elastic.py``).

The recovery contract: checkpoints are whole leaves plus a manifest
(``checkpoint/manager.py``), whatever mesh wrote them, so after a
failure the trainer (i) picks the largest mesh the survivors can form
(:func:`surviving_mesh`), (ii) rebuilds the shardings from the same
logical axis rules, and (iii) restores the latest complete checkpoint
onto the new mesh, each rank reading only its own blocks into blocks
made from the manifest alone: the re-cut.  Nothing is drawn that the
restore overwrites: ``build`` gets the restored state and draws one
only when there is no checkpoint, and a cell built to give the
shardings is built undrawn (``steps.build_cell(..., draw=False)``).
It keeps no in-memory state across a failure and resumes at the step
after the checkpoint.  Data streams are pure functions of (seed, step),
so the resumed run sees the batches the uninterrupted one would have.

Without ``shardings`` the trainer is the JAX one on one process:
``build`` gets ``n_devices`` and the restored state whole, on the CPU.
With it, every rank of the live group runs :meth:`ElasticTrainer.run`,
and the first attempt, and each after a :class:`DeviceLoss` changes the
count, forms its mesh with ``surviving_mesh(n_devices, ...)`` over the
first ranks of the group (collectively: every rank of the group calls
it).  A rank outside it gets ``(None, log)`` back and takes no further
part, so the mesh is formed again only while it spans the whole group.
The checkpoint's collectives run over the mesh's group on the caller's
thread (the manager's docstring).  A :class:`DeviceLoss` from a step
names the devices left; any other ``RuntimeError`` restarts on as many
as before.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch.distributed as dist

from ..checkpoint import CheckpointManager
from ..shardlib import make_mesh
from .watchdog import StepMonitor, StragglerPolicy


def surviving_mesh(n_devices: int, axis_names: Sequence[str] = ("data",
                                                                "model"),
                   model_parallelism: int = 1, device_type: str = "cuda"):
    """Largest (data, model) ``DeviceMesh`` over the first ``n_devices``
    ranks of the live group.

    Model parallelism is fixed by memory (a shard must fit), so
    survivors re-form ``(n // model_parallelism, model_parallelism)``;
    leftover ranks idle (standard practice: better than a ragged mesh)
    and get ``None``.  Every rank of the live group calls it (the mesh's
    groups are made collectively).
    """
    dp = min(n_devices, dist.get_world_size()) // model_parallelism
    if dp < 1:
        raise RuntimeError("not enough devices for one model shard")
    return make_mesh((dp, model_parallelism), axis_names, device_type,
                     ranks=range(dp * model_parallelism))


class DeviceLoss(RuntimeError):
    """A failure that leaves ``n_devices`` devices: the trainer restarts
    on the mesh they form."""

    def __init__(self, n_devices: int, message: str = ""):
        super().__init__(message or f"{n_devices} devices survive")
        self.n_devices = n_devices


@dataclasses.dataclass
class ElasticTrainer:
    """Restart loop: run steps, checkpoint every k, recover on failure.

    ``build`` is called with (n_devices, restored state | None) and must
    return (state, step_fn), drawing a state only for ``None``;
    ``step_fn(state, step)`` returns the next state.  A restored state is the checkpoint's tree in the manifest's
    layout (dicts and lists; an ``OptState`` as a dict): whole, as CPU
    tensors, or with ``shardings`` this rank's blocks.
    ``failure_injector`` lets tests raise at chosen steps: a
    ``RuntimeError`` restarts from the latest checkpoint, once the
    manager's write in flight (async mode) has landed.  (The JAX loop
    looks for the latest step at once, so after a failure just past an
    async save it may restart from an older one.)

    ``shardings``, optional, gives the target shardings of the state on
    a mesh (a tree of ``NamedSharding``, such as the rebuilt cell's
    ``in_shardings[0]``).  With it the trainer forms
    ``surviving_mesh(n_devices)`` on the live group's device type (kept
    as :attr:`mesh`, for ``build``) first and after each
    :class:`DeviceLoss`, restores onto ``shardings(mesh)`` and saves by
    blocks under them; a rank outside the mesh returns ``(None, log)``.
    """
    ckpt: CheckpointManager
    build: Callable
    total_steps: int
    ckpt_every: int = 10
    monitor: Optional[StepMonitor] = None
    failure_injector: Optional[Callable[[int], None]] = None
    max_restarts: int = 5
    shardings: Optional[Callable[[Any], Any]] = None
    #: the current attempt's mesh (None without ``shardings``)
    mesh: Any = dataclasses.field(default=None, init=False)

    def run(self, n_devices: int = 1) -> Tuple[Optional[Dict], Dict]:
        restarts, formed = 0, None
        log = {"restarts": 0, "steps_run": 0, "resumed_from": [],
               "meshes": []}
        mon = self.monitor or StepMonitor(StragglerPolicy())
        while True:
            start = 0
            restored = target = None
            # a write still in flight from before the failure completes
            # first: its step is the latest checkpoint to resume from
            self.ckpt.wait()
            if self.shardings is not None:
                if formed != n_devices:
                    self._form_mesh(n_devices, formed)
                    formed = n_devices
                if self.mesh is None:
                    return None, log
                log["meshes"].append(tuple(self.mesh.mesh.shape))
                target = self.shardings(self.mesh)
            last = self.ckpt.latest_step(self.mesh)
            if last is not None:
                template, _ = self.ckpt.peek(last)
                restored, extra = self.ckpt.restore(template, step=last,
                                                    shardings=target)
                start = int(extra["step"]) + 1
                log["resumed_from"].append(start - 1)
            state, step_fn = self.build(n_devices, restored)
            try:
                for step in range(start, self.total_steps):
                    if self.failure_injector is not None:
                        self.failure_injector(step)
                    mon.start_step()
                    state = step_fn(state, step)
                    mon.end_step()
                    log["steps_run"] += 1
                    if (step + 1) % self.ckpt_every == 0 \
                            or step == self.total_steps - 1:
                        self.ckpt.save(step, state, shardings=target)
                self.ckpt.wait()
                return state, log
            except RuntimeError as e:
                restarts += 1
                log["restarts"] = restarts
                if restarts > self.max_restarts:
                    raise
                if isinstance(e, DeviceLoss):
                    n_devices = e.n_devices
                continue  # restart from latest checkpoint

    def _form_mesh(self, n_devices: int, formed: Optional[int]) -> None:
        """:attr:`mesh` on ``n_devices`` of the live group: its groups
        are made over every rank of the group, so only while the last
        mesh (if any) spans it."""
        if formed is not None and self.mesh.size() < dist.get_world_size():
            raise RuntimeError(
                f"cannot re-form the mesh on {n_devices} devices: ranks "
                f"left the last one of {self.mesh.size()}")
        self.mesh = surviving_mesh(n_devices, device_type=(
            "cuda" if dist.get_backend() == "nccl" else "cpu"))
