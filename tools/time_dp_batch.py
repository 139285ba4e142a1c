#!/usr/bin/env python3
"""Time a tree's HoD batch split (``--data-parallel``) at world size 1
over NCCL beside the unsharded engine, on one GPU: host clock by part,
device time by kernel, host time by operator, and served q/s.

    python3 tools/time_dp_batch.py [--tree DIR] [--reps N]

Imports ``repro_torch`` from ``DIR/src`` (by default this checkout's)
and builds the index ``chip_smoke.py`` serves (``chip_smoke.served_index``:
the road stand-in, grid side 200, the core closed on the card).  Then,
in one NCCL group of one rank, for the unsharded engine ("plain") and
under ``axis_rules(mesh, {"batch": "data"})`` ("split"), in turns
(plain, split, split, plain, ``--reps`` rounds):

* ``QueryEngine.ssd`` on one batch of 32 sources, and its parts: the
  host's share and permutation of the sources (``_share`` where the
  tree has it, ``_perm_ids``), the sweeps and core search
  (``_ssd_dev``, then ``torch.cuda.synchronize()``) and the answer's
  way to the host (``_to_host``: the transpose, the gather and the
  copy); host clock, medians;
* ``QueryServer.serve_stream`` over ``chip_smoke.py``'s stream (256
  requests from 160 sources) on a new server warmed by one batch: q/s;
* ``torch.profiler`` over ``--reps`` batches of each: device time a
  batch by kernel and copy, the device's idle share, and host (CPU)
  self time a batch by operator, the rows that differ most first.

It prints the card's name and power limit, then one JSON line.  The
host clock spreads between machines, so to compare two trees run them
in turns on one machine: A, B, B, A.
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _parts(torch, eng, batch) -> dict:
    """Host-clock milliseconds of one ``eng.ssd(batch)`` by part."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    share = getattr(eng, "_share", lambda b: b)
    ids = eng._perm_ids(share(batch))
    t1 = time.perf_counter()
    state = eng._ssd_dev(ids)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    eng._to_host(state)
    t3 = time.perf_counter()
    return {"share_perm": (t1 - t0) * 1e3, "ssd_dev": (t2 - t1) * 1e3,
            "to_host": (t3 - t2) * 1e3, "total": (t3 - t0) * 1e3}


def _profile(torch, step, reps: int) -> dict:
    """Device time by kernel, idle share and host self time by operator,
    a call, over ``reps`` calls of ``step``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev, host = {}, {}
    for e in prof.key_averages():
        d_us = getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
        if d_us > 0 and e.device_type != DeviceType.CPU:
            dev[e.key] = d_us / reps
        if e.self_cpu_time_total > 0:
            host[e.key] = e.self_cpu_time_total / reps
    busy = sum(dev.values())
    return {"wall_us": wall_us / reps, "device_busy_us": busy,
            "idle_share": (1 - busy * reps / wall_us) if dev else None,
            "device_us": dev, "host_self_us": host}


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
    from repro_torch import shardlib as sl
    from repro_torch.core import QueryEngine
    from repro_torch.launch.mesh import distributed
    from repro_torch.launch.serve import QueryServer

    card = cs.card_line()
    g, ix = cs.served_index(torch, card, cs.SIDE, cs.CLOSURE_LIMIT)
    eng = QueryEngine(ix, device="cuda")
    rng = np.random.default_rng(0)
    pool = rng.choice(g.n, size=cs.REQUEST_POOL, replace=False)
    requests = rng.choice(pool, size=cs.REQUESTS).astype(np.int32)
    batch = np.sort(pool[:cs.BATCH]).astype(np.int32)

    parts = {"plain": [], "split": []}
    qps = {"plain": [], "split": []}
    prof = {}
    with distributed("cuda"):
        mesh = sl.make_mesh((1,), ("data",), "cuda")

        def under(mode):
            if mode == "split":
                return sl.axis_rules(mesh, {"batch": "data"})
            return contextlib.nullcontext()

        for mode in ("plain", "split"):
            with under(mode):
                eng.ssd(batch)
        for _ in range(args.reps):
            for mode in ("plain", "split", "split", "plain"):
                with under(mode):
                    parts[mode].append(_parts(torch, eng, batch))
        for _ in range(max(args.reps // 4, 1)):
            for mode in ("plain", "split", "split", "plain"):
                with under(mode):
                    server = QueryServer(eng, batch_size=cs.BATCH,
                                         warm_start=True)
                    t0 = time.perf_counter()
                    server.serve_stream(requests)
                    qps[mode].append(len(requests)
                                     / (time.perf_counter() - t0))
        for mode in ("plain", "split"):
            with under(mode):
                prof[mode] = _profile(torch, lambda: eng.ssd(batch),
                                      args.reps)

    med = {m: {k: float(np.median([p[k] for p in ps])) for k in ps[0]}
           for m, ps in parts.items()}
    host = {k: (prof["split"]["host_self_us"].get(k, 0.0),
                prof["plain"]["host_self_us"].get(k, 0.0))
            for k in set(prof["split"]["host_self_us"])
            | set(prof["plain"]["host_self_us"])}
    diff = sorted(host.items(), key=lambda kv: -(kv[1][0] - kv[1][1]))
    print(card, flush=True)
    for m in ("plain", "split"):
        print(f"{m}: batch parts (ms, median of {len(parts[m])}) {med[m]};"
              f" serve q/s {[round(q, 1) for q in qps[m]]}; profiler wall "
              f"{prof[m]['wall_us']:.1f} us, device busy "
              f"{prof[m]['device_busy_us']:.1f} us a batch", flush=True)
    print("host self time a batch, split minus plain (us):", flush=True)
    for k, (a, b) in diff[:12]:
        print(f"  {a - b:9.1f}  split {a:9.1f}  plain {b:9.1f}  {k[:70]}",
              flush=True)
    print(json.dumps({
        "tree": str(Path(args.tree).resolve()), "card": card,
        "parts_ms_median": med,
        "serve_qps": {m: {"median": float(np.median(q)), "all": q}
                      for m, q in qps.items()},
        "profile": {m: {k: v for k, v in p.items() if k != "host_self_us"}
                    for m, p in prof.items()},
        "host_self_us_split_minus_plain": {
            k: a - b for k, (a, b) in diff[:20]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
