#!/usr/bin/env python3
"""Time a tree's ``edge_relax`` kernel on the served index's real levels.

    python3 tools/time_edge_relax.py [--tree DIR] [--iters N]
                                     [--blocks B,B,...]

Imports ``repro_torch`` from ``DIR/src`` (by default this checkout's) and
times its ``edge_relax`` kernel on one GPU, on the levels a served SSD
batch relaxes: ``chip_smoke.served_index`` without the core closure,
S = 32 sources, random labels from a seed.  It knows the two kernel
interfaces the port has had:

* ``relax_sweep_``: node-major ``[N, S]`` labels and packed sweeps, one
  launch a sweep;
* ``relax_level_``: source-major ``[S, N]`` labels and bucketed levels,
  one launch a level (the port before the sweep kernel, timed from a
  ``git archive`` of that tree).

Each whole sweep (``plan_f``, ``plan_b``) and the widest forward level
alone are checked ``torch.equal`` to the same tree's plain version, then
timed by ``chip_smoke.time_ms(queued=True)``, each run restoring the
labels first (the restore copy is timed alone and subtracted).
``--blocks`` also times each whole sweep at those cooperative grid sizes
in place of the planned one (``relax_sweep_`` only).  It prints the
card's name and power limit, then one JSON line.  To compare two trees,
run it for each in turns on one machine: A, B, B, A.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
S = 32


def runs(np, er, query, ix):
    """(interface, source-major?, {name: (kernel run, plain run,
    launches, sweep or None)}) over the index's real levels, each run in
    place on the labels it is given."""
    if hasattr(er, "relax_sweep_"):
        f = query._plan_sweep(ix.plan_f, ix.n_pad, "cuda")
        b = query._plan_sweep(ix.plan_b, ix.n_pad, "cuda")
        widest = int(np.argmax(f.level_widths))

        def one(sweep):
            return (lambda d: er.relax_sweep_(d, sweep),
                    lambda d: er.relax_sweep_ref_(d, sweep), 1, sweep)

        return "relax_sweep_", False, {
            "plan_f": one(f), "plan_b": one(b),
            f"plan_f level {widest}": one(f.level(widest))}
    lf = query._plan_levels(ix.plan_f, ix.n_pad, "cuda")
    lb = query._plan_levels(ix.plan_b, ix.n_pad, "cuda")
    widest = int(np.argmax([int(lvl[4].sum()) for lvl in lf]))

    def each(levels):
        def kernel(d):
            for dst, src_idx, w, _, valid in levels:
                er.relax_level_(d, dst, src_idx, w, valid)

        def plain(d):
            for dst, src_idx, w, _, valid in levels:
                er.relax_level_ref_(d, dst, src_idx, w, valid)

        return kernel, plain, len(levels), None

    return "relax_level_", True, {
        "plan_f": each(lf), "plan_b": each(lb),
        f"plan_f level {widest}": each(lf[widest:widest + 1])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--blocks", default="",
                    help="comma-separated grid sizes to time the sweeps at")
    args = ap.parse_args()
    src = Path(args.tree).resolve() / "src"
    if not (src / "repro_torch").is_dir():
        print(f"no src/repro_torch under {args.tree}", file=sys.stderr)
        return 2
    sys.path[:0] = [str(src), str(ROOT)]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import query
    from repro_torch.kernels import edge_relax as er

    card = cs.card_line()
    cs.SM_HZ = cs.fp32_instr_per_s(torch)[1] * 1e6
    _, ix = cs.served_index(torch, card, cs.SIDE, closure_limit=0)
    api, source_major, todo = runs(np, er, query, ix)
    gen = torch.Generator(device="cuda").manual_seed(14)
    dist = torch.randint(0, 200, (ix.n_pad, S), generator=gen,
                         device="cuda").float()
    dist[torch.rand(dist.shape, generator=gen, device="cuda") < 0.25] = \
        float("inf")
    dist[ix.n] = float("inf")
    if source_major:
        dist = dist.t().contiguous()
    scratch = dist.clone()

    def timed(fn):
        return cs.time_ms(torch, lambda: fn(scratch.copy_(dist)),
                          args.iters, queued=True)

    copy_ms = timed(lambda d: d)
    out = {"tree": str(Path(args.tree).resolve()), "api": api,
           "card": card, "s": S, "ms": {}, "launches": {}, "at_blocks": {}}
    for name, (kernel, plain, launches, _) in todo.items():
        got, want = dist.clone(), dist.clone()
        kernel(got)
        plain(want)
        torch.cuda.synchronize()
        if not torch.equal(got, want) or torch.equal(got, dist):
            raise AssertionError(f"{api} {name}: differs from the plain "
                                 "version, or changed nothing")
        out["ms"][name] = timed(kernel) - copy_ms
        out["launches"][name] = launches
    out["ms"]["batch"] = out["ms"]["plan_f"] + out["ms"]["plan_b"]
    if args.blocks and api == "relax_sweep_":
        ops = sys.modules["repro_torch.kernels.edge_relax.ops"]
        planned = ops.plan_sweep_launch
        for blocks in map(int, args.blocks.split(",")):
            ops.plan_sweep_launch = lambda *a, _b=blocks: \
                planned(*a)._replace(blocks=_b)
            out["at_blocks"][blocks] = at = {}
            for name in ("plan_f", "plan_b"):
                kernel, plain = todo[name][:2]
                at[name] = timed(kernel) - copy_ms
                if not torch.equal(scratch, plain(dist.clone())):
                    raise AssertionError(f"{name} at {blocks} blocks "
                                         "differs from the plain version")
        ops.plan_sweep_launch = planned
    print(card, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
