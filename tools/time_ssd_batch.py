#!/usr/bin/env python3
"""Time a tree's served SSD batches on one GPU: host clock and device
time by kernel.

    python3 tools/time_ssd_batch.py [--tree DIR] [--reps N]

Imports ``repro_torch`` from ``DIR/src`` (by default this checkout's)
and builds the index ``chip_smoke.py`` serves (``chip_smoke.served_index``:
the road stand-in, grid side 200, the 15,722-node core closed on the
card).  Then, after one warm-up batch:

* ``QueryEngine.ssd`` on one batch of 32 sources, ``--reps`` times, each
  ending in ``torch.cuda.synchronize()`` (host clock: what a served
  batch costs, host and device together);
* ``chip_smoke.profile_device`` over ``--reps`` such batches: wall and
  device-busy time a batch, the device's idle share, and device time a
  batch by kernel and copy;
* ``QueryServer.serve_stream`` over ``chip_smoke.py``'s stream (256
  requests from 160 sources), ``--reps`` times, each on a new server
  warmed by one batch: q/s of every pass in order, and the medians of
  q/s and of each pass's latency percentiles.

It prints the card's name and power limit, then one JSON line.  The
host clock spreads between machines, so to compare two trees run them
in turns on one machine: A, B, B, A.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--reps", type=int, default=20)
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
    from repro_torch.core import QueryEngine
    from repro_torch.launch.serve import QueryServer

    card = cs.card_line()
    g, ix = cs.served_index(torch, card, cs.SIDE, cs.CLOSURE_LIMIT)
    eng = QueryEngine(ix, device="cuda")
    rng = np.random.default_rng(0)
    pool = rng.choice(g.n, size=cs.REQUEST_POOL, replace=False)
    requests = rng.choice(pool, size=cs.REQUESTS).astype(np.int32)
    batch = np.sort(pool[:cs.BATCH]).astype(np.int32)
    eng.ssd(batch)
    torch.cuda.synchronize()
    batch_ms = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        eng.ssd(batch)
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    prof = cs.profile_device(torch, lambda: eng.ssd(batch), args.reps,
                             f"SSD batches of {cs.BATCH}", card)
    qps, p50, p99 = [], [], []
    for _ in range(args.reps):
        server = QueryServer(eng, batch_size=cs.BATCH, warm_start=True)
        t0 = time.perf_counter()
        results = server.serve_stream(requests)
        qps.append(len(requests) / (time.perf_counter() - t0))
        lat = np.array([r.latency_s for r in results]) * 1e3
        p50.append(float(np.percentile(lat, 50)))
        p99.append(float(np.percentile(lat, 99)))
    print(card, flush=True)
    print(json.dumps({
        "tree": str(Path(args.tree).resolve()), "card": card,
        "ssd_batch_ms": {"median": float(np.median(batch_ms)),
                         "min": min(batch_ms), "max": max(batch_ms)},
        "profile": prof,
        "serve_qps": {"median": float(np.median(qps)), "min": min(qps),
                      "max": max(qps)},
        "serve_qps_by_pass": [round(q, 1) for q in qps],
        "latency_p50_ms_median": float(np.median(p50)),
        "latency_p99_ms_median": float(np.median(p99))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
