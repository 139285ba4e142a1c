"""Training entry point of the port: glm4-9b, dlrm-rm2 or a GNN (gcn-cora,
gin-tu, schnet, equiformer-v2) on one card, checkpointed and resumable.

    PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-rm2 \\
        --smoke --steps 3 --device cpu

The JAX package's ``launch/train.py`` without the mesh: the cell
builder, the checkpoint manager (async, keep-last-3), the step monitor
(straggler and hang verdicts) and a resume from the newest complete
checkpoint.  Step ``i`` trains on batch ``i`` of the arch's data stream
(``cell.batch_at``), a pure function of (seed, step), so a resumed run
sees the batches an uninterrupted one would.  ``--smoke`` trains the
reduced config; without it the full config at the assigned shape
(dlrm-rm2 and every GNN cell fit one card; glm4-9b's 40 layers with f32
AdamW state, 16 bytes a parameter, do not: ``build_cell(..., layers=,
batch=)`` cuts them, as ``chip_smoke.py`` does).  For a GNN the default
shape ``train_4k`` means ``full_graph_sm``, as in the JAX module.  It
runs on the card unless ``--device cpu``.  The other archs of the JAX
package wait for their modules (``ROADMAP.md`` queue 1).
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import List, Optional

from ..checkpoint import CheckpointManager
from ..configs import ARCH_IDS, get_arch
from ..device import resolve_device
from ..ft import StepMonitor
from .steps import build_cell


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv: Optional[List[str]] = None) -> dict:
    """Train; returns the last step and its metrics as floats."""
    args = build_arg_parser().parse_args(argv)
    if args.arch not in ARCH_IDS:
        raise NotImplementedError(
            f"the port trains {ARCH_IDS}; {args.arch!r} waits for its "
            "modules (ROADMAP.md queue 1)")
    device = resolve_device(args.device)
    mod = get_arch(args.arch)
    shape = args.shape
    if mod.FAMILY == "gnn" and shape == "train_4k":
        shape = "full_graph_sm"
    if mod.FAMILY == "recsys" and shape == "train_4k":
        shape = "train_batch"

    mgr = CheckpointManager(args.ckpt_dir, keep_last=3)
    mon = StepMonitor()
    cell = build_cell(args.arch, shape, smoke=args.smoke, device=device)
    if cell.kind != "train":
        raise ValueError(f"{args.arch} {shape} is a {cell.kind} shape, not "
                         "a train shape")
    state = cell.args[0]
    start = 0
    if mgr.latest_step() is not None:
        state, extra = mgr.restore(state, device=device)
        start = int(extra["step"]) + 1
        print(f"resumed from step {start - 1}")

    out = {}
    for step in range(start, args.steps):
        batch = cell.batch_at(step)
        mon.start_step()
        state, metrics = cell.fn(state, *batch)
        loss = float(metrics["loss"])           # waits for the step
        verdict = mon.end_step()
        if verdict != "ok":
            print(f"[ft] step {step}: {verdict} "
                  f"(median {mon.median * 1e3:.0f} ms)")
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"({mon.median * 1e3:.0f} ms/step)")
        if (step + 1) % args.ckpt_every == 0 or step == args.steps - 1:
            mgr.save(step, state)
        out.update(step=step, loss=loss, gnorm=float(metrics["gnorm"]))
    mgr.wait()
    print("done")
    return out


if __name__ == "__main__":
    main()
