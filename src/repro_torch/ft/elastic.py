"""Crash-restart training loop and the survivors' mesh (the JAX
package's ``ft/elastic.py``).

The recovery contract: checkpoints are plain host arrays plus a manifest
(``checkpoint/manager.py``), so after a failure the trainer rebuilds its
state from the latest complete checkpoint, with no surviving in-memory
state, and resumes at the step after it.  Data streams are pure
functions of (seed, step), so the resumed run sees the batches the
uninterrupted one would have.

``surviving_mesh`` re-forms the largest data x model mesh from the
surviving ranks (the first ``n_devices`` of the live group); the
trainer passes ``n_devices`` through to ``build``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

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


@dataclasses.dataclass
class ElasticTrainer:
    """Restart loop: run steps, checkpoint every k, recover on failure.

    ``build`` is called with (n_devices, restored state | None) and must
    return (state, step_fn); ``step_fn(state, step)`` returns the next
    state.  A restored state is the checkpoint's tree as CPU tensors in
    the manifest's layout (dicts and lists; an ``OptState`` as a dict).
    ``failure_injector`` lets tests raise at chosen steps: a
    ``RuntimeError`` restarts from the latest checkpoint, once the
    manager's write in flight (async mode) has landed.  (The JAX loop
    looks for the latest step at once, so after a failure just past an
    async save it may restart from an older one.)
    """
    ckpt: CheckpointManager
    build: Callable
    total_steps: int
    ckpt_every: int = 10
    monitor: Optional[StepMonitor] = None
    failure_injector: Optional[Callable[[int], None]] = None
    max_restarts: int = 5

    def run(self, n_devices: int = 1) -> Tuple[Dict, Dict]:
        restarts = 0
        log = {"restarts": 0, "steps_run": 0, "resumed_from": []}
        mon = self.monitor or StepMonitor(StragglerPolicy())
        while True:
            start = 0
            restored = None
            # a write still in flight from before the failure completes
            # first: its step is the latest checkpoint to resume from
            self.ckpt.wait()
            if self.ckpt.latest_step() is not None:
                template, extra = self.ckpt.peek()
                restored, extra = self.ckpt.restore(template)
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
                        self.ckpt.save(step, state)
                self.ckpt.wait()
                return state, log
            except RuntimeError:
                restarts += 1
                log["restarts"] = restarts
                if restarts > self.max_restarts:
                    raise
                continue  # restart from latest checkpoint
