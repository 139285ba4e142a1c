"""Training entry point of the port: any arch of the registry (the LMs
glm4-9b, command-r-35b, gemma3-12b, granite-moe-1b-a400m and
qwen3-moe-30b-a3b; dlrm-rm2; the GNNs gcn-cora, gin-tu, schnet and
equiformer-v2) on a mesh of ranks, checkpointed and resumable.

    PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-rm2 \\
        --smoke --steps 3 --device cpu
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.train --arch gcn-cora --smoke --steps 4 \\
        --device cpu

The JAX package's ``launch/train.py``: inside ``launch.mesh.distributed``
(torchrun's world, or this one process; NCCL on ``cuda:LOCAL_RANK``,
gloo with ``--device cpu``) the cell is built under
``shardlib.axis_rules(mesh, rules_for(arch, shape, mesh))`` on
``make_smoke_mesh``, the ``(1, world)`` mesh, so each rank holds its
blocks of the state.  Then the checkpoint manager (async, keep-last-3),
the step monitor (straggler and hang verdicts) and a resume from the
newest complete checkpoint, which every rank agrees on: a resumed run
builds its cell's state undrawn (``build_cell(draw=False)``) and
restores into those blocks in place, so nothing is drawn that the
restore overwrites.  Checkpoints go
by blocks under the cell's ``in_shardings[0]``: each rank writes its
own blocks of the whole leaves and restores only its own, so a run
resumes on another world size whose mesh divides the shapes, and from a
checkpoint the JAX package wrote (``checkpoint/manager.py``).  The
checkpoint's collectives run on this thread, between steps;
``--ckpt-dir`` must be one filesystem that every rank sees.  Rank 0
logs.  At world 1 every sharded cell is the unsharded one, bit for bit.

Step ``i`` trains on batch ``i`` of the arch's data stream
(``cell.batch_at``), a pure function of (seed, step), so a resumed run
sees the batches an uninterrupted one would.  ``--smoke`` trains the
reduced config; without it the full config at the assigned shape
(dlrm-rm2, every GNN cell and granite-moe fit one card; the other LMs'
full depth with f32 AdamW state, 16 bytes a parameter, does not:
``build_cell(..., layers=, batch=)`` cuts them, as ``chip_smoke.py``
does).  For a GNN the default shape ``train_4k`` means
``full_graph_sm``, as in the JAX module.  It runs on the card unless
``--device cpu``.  ``--deterministic`` turns torch's deterministic
algorithms on (warn only) and logs each op torch reports without a
deterministic path.  The last line before ``done`` gives this process's
launches of the port's kernels.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import warnings
from typing import List, Optional

import torch
import torch.distributed as dist

from .. import shardlib as sl
from ..checkpoint import CheckpointManager
from ..configs import ARCH_IDS, get_arch
from ..ft import StepMonitor
from ..kernels import launch_counters
from .mesh import distributed, make_smoke_mesh
from .steps import build_cell, rules_for


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--deterministic", action="store_true")
    return ap


def main(argv: Optional[List[str]] = None) -> dict:
    """Train; returns the last step and its metrics as floats (on every
    rank)."""
    args = build_arg_parser().parse_args(argv)
    mod = get_arch(args.arch)
    shape = args.shape
    if mod.FAMILY == "gnn" and shape == "train_4k":
        shape = "full_graph_sm"
    if mod.FAMILY == "recsys" and shape == "train_4k":
        shape = "train_batch"
    with distributed(args.device) as device:
        if not args.deterministic:
            return _train(args, shape, device)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = _train(args, shape, device)
        finally:
            torch.use_deterministic_algorithms(False)
        if dist.get_rank() == 0:
            for op in sorted({str(w.message).split(".")[0] for w in caught
                              if "deterministic" in str(w.message)}):
                print(f"no deterministic path: {op}")
        return out


def _train(args, shape: str, device: torch.device) -> dict:
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    mesh = make_smoke_mesh(device)
    mgr = CheckpointManager(args.ckpt_dir, keep_last=3)
    mon = StepMonitor()
    out = {}
    with sl.axis_rules(mesh, rules_for(args.arch, shape, mesh)):
        last = mgr.latest_step(mesh)
        # a resume builds the state undrawn and restores into its blocks
        cell = build_cell(args.arch, shape, smoke=args.smoke, device=device,
                          draw=last is None)
        if cell.kind != "train":
            raise ValueError(f"{args.arch} {shape} is a {cell.kind} shape, "
                             "not a train shape")
        shardings = cell.in_shardings[0]
        state = cell.args[0]
        start = 0
        if last is not None:
            state, extra = mgr.restore(state, step=last, device=device,
                                       shardings=shardings, into=True)
            start = int(extra["step"]) + 1
            say(f"resumed from step {start - 1}")

        for step in range(start, args.steps):
            batch = cell.batch_at(step)
            mon.start_step()
            state, metrics = cell.fn(state, *batch)
            loss = float(metrics["loss"])           # waits for the step
            verdict = mon.end_step()
            if verdict != "ok":
                say(f"[ft] step {step}: {verdict} "
                    f"(median {mon.median * 1e3:.0f} ms)")
            if step % args.log_every == 0 or step == args.steps - 1:
                say(f"step {step:5d} loss {loss:.4f} "
                    f"({mon.median * 1e3:.0f} ms/step)")
            if (step + 1) % args.ckpt_every == 0 or step == args.steps - 1:
                mgr.save(step, state, shardings=shardings)
            out.update(step=step, loss=loss, gnorm=float(metrics["gnorm"]))
        mgr.wait()
    say("kernel launches " + json.dumps(
        {name: fn.launches for name, fn in launch_counters().items()}))
    say("done")
    return out


if __name__ == "__main__":
    main()
