#!/usr/bin/env python3
"""The precision control of ``correct``: the plain reference put in the
program's place, computed one precision below the configuration's
float32 (bfloat16), and judged by the same comparison as a run.

    python3 hodbench/control.py --workload road-ssd --seeds 11 12 13

For each seed it makes the cell's graph and the mix's first
``checked_rows`` sources as a run of that seed does, computes their rows
in float64 (the reference) and in bfloat16 (the control) on the card,
holds the control's rows to the reference by ``verdict.judge``, the
comparison of a run, and prints one JSON line a seed: each number beside
its limit and ``correct``, which has to read false.  The benchmark's own
runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_numbers(root, bench, cell, seed: int, device: str,
                    dtype=None) -> dict:
    """The control's numbers for one seed of ``cell``."""
    import numpy as np
    import torch

    from hodbench import loadgen, spec, verdict
    from hodbench.reference import shortest_distances
    from hodbench.run import seed_streams

    dtype = torch.bfloat16 if dtype is None else dtype
    cfg, mix = cell.config, cell.traffic
    s_graph, s_traffic, _ = seed_streams(seed)
    gen = spec.load_module(spec.find(root, bench, "graphs",
                                     f"{cfg['graph']['kind']}.py"))
    n, src, dst, w = gen.edges(cfg["graph"], np.random.default_rng(s_graph))
    rows = loadgen.draw_sources(mix["sources"], n,
                                np.random.default_rng(s_traffic),
                                count=int(mix["checked_rows"]))
    t0 = time.perf_counter()
    ref = shortest_distances(n, src, dst, w, rows, device=device)
    t1 = time.perf_counter()
    low = shortest_distances(n, src, dst, w, rows, device=device,
                             dtype=dtype)
    numbers = dict(verdict.check_rows(ref, low, rows), failed=0)
    correct, checks = verdict.judge(numbers, len(rows))
    return {"workload": cell.name, "seed": seed, "dtype": str(dtype),
            "correct": correct, "checks": checks, "reference_s": t1 - t0,
            "control_s": time.perf_counter() - t1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    import torch

    from hodbench import spec
    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 2
    bench = spec.load(ROOT)
    cell = spec.cell(ROOT, bench, args.workload)
    failed = 0
    for seed in args.seeds:
        out = control_numbers(ROOT, bench, cell, seed, "cuda")
        failed += not out["correct"]
        print(json.dumps(out), flush=True)
    print(f"the control read not correct on {failed} of {len(args.seeds)} "
          "seeds", file=sys.stderr)
    return 0 if failed == len(args.seeds) else 1


if __name__ == "__main__":
    sys.exit(main())
