"""Fleet smoke check: build → ``save_store`` → serve the checked in
``configs/serve_fleet.yaml`` mixed workload as an unsharded server and
as N ∈ {1, 2} fleets.  The port's twin of the JAX package's
``fleet/smoke.py``: the engines run on the card (``edge_relax`` a
streamed level, ``tropical_matmul`` for the core) unless it is given
``--device cpu``.  It asserts end to end:

* **bit-identity**: every fleet answer (any N) equals the unsharded
  server's answer for the same request, which itself equals a
  singleton call on the in-memory engine — shards partition storage,
  not math;
* **degenerate fleet**: at N=1 the fleet's aggregate cache counters
  (hits, misses, bytes read, bytes filled) equal the unsharded
  server's exactly — the routing façades add bookkeeping, never
  behavior;
* **real sharding**: at N=2 every shard that owns blocks served
  traffic with a strictly positive hit rate, per-shard bytes sum to
  the fleet aggregate, and the answers stayed bit-identical;
* **data-parallel plumbing**: the N=2 leg runs under a live ``("data",)``
  mesh of this process's group with the rules ``{"batch": "data"}``
  (the batch split the serve CLI's ``--data-parallel`` uses; one rank
  here, over gloo on the CPU or NCCL on the card);
* **tracing**: the N=2 leg runs under a ``Tracer`` whose Chrome trace
  validates;
* **artifacts**: set ``FLEET_TRACE_OUT=<path>`` to keep the N=2 leg's
  Chrome trace and ``FLEET_BENCH_OUT=<path>`` for a schema-stamped
  JSON of the per-leg fleet stats.

    PYTHONPATH=src python -m repro_torch.fleet.smoke
    PYTHONPATH=src python -m repro_torch.fleet.smoke --device cpu
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import tempfile
from typing import List, Optional

import numpy as np
import torch.distributed as dist

from .. import shardlib as sl
from ..config import SERVE_DEFAULTS, Config
from ..core import (BuildConfig, QueryEngine, build_hod,
                    gnm_random_digraph, pack_index)
from ..device import resolve_device
from ..launch.mesh import distributed
from ..launch.serve import mixed_request_stream, server_from_config
from ..storage.blockfile import segment_logical_bytes

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


def _fleet_config(requests: int = 64) -> Config:
    """The checked-in fleet config (or an inline twin for installed
    trees without ``configs/``), minus the shard count — each leg sets
    its own."""
    cfg_path = os.path.join(_REPO_ROOT, "configs", "serve_fleet.yaml")
    cfg = Config(cfg_path if os.path.exists(cfg_path) else None,
                 defaults=SERVE_DEFAULTS,
                 overrides={"serve": {"requests": requests, "batch": 8}})
    if not cfg.get("serve.mix"):
        cfg.data["serve"].update(
            scheduler="slo", mix={"ssd": 1, "p2p": 3},
            slo={"ssd": {"deadline_ms": 200.0},
                 "p2p": {"deadline_ms": 60.0, "batch": 8}})
        cfg.data.setdefault("store", {}).update(enabled=True,
                                                codec="delta")
    return cfg


def _serve_leg(cfg: Config, store_dir: str, budget: int, stream,
               shards, device: str, tracer=None):
    """Serve the mixed stream once; returns (answers, server) with the
    server already closed."""
    cfg.data["serve"]["shards"] = shards
    server = server_from_config(cfg, store_path=store_dir,
                                cache_bytes=budget, tracer=tracer,
                                engine_opts={"device": device})

    async def drive():
        tasks = [asyncio.create_task(server.submit(*a, mode=m))
                 for m, a in stream]
        await asyncio.sleep(0)
        await server.drain()
        return await asyncio.gather(*tasks)

    try:
        server.warmup()
        answers = asyncio.run(drive())
    finally:
        server.close()
    return answers, server


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    dev = str(resolve_device(ap.parse_args(argv).device))
    g = gnm_random_digraph(200, 800, seed=11, weighted=True)
    res = build_hod(g, BuildConfig(max_core_nodes=32,
                                   max_core_edges=1024, seed=0))
    ix = pack_index(g, res, chunk=64, device=dev)
    cfg = _fleet_config()

    with tempfile.TemporaryDirectory() as tmp:
        store_dir = f"{tmp}/store"
        ix.save_store(store_dir, block_bytes=4096,
                      codec=cfg.get("store.codec", "delta"))
        budget = int(float(cfg.get("store.cache_frac", 0.25))
                     * segment_logical_bytes(store_dir))
        stream = mixed_request_stream(cfg, g.n,
                                      int(cfg.get("serve.requests")),
                                      np.random.default_rng(5))

        # Leg 0 — unsharded reference, itself checked against the
        # in-memory engine (the smoke's ground truth).
        ref, solo = _serve_leg(cfg, store_dir, budget, stream, None, dev)
        eng_mem = QueryEngine(ix, device=dev)
        for (m, a), r in zip(stream, ref):
            if m == "p2p":
                np.testing.assert_array_equal(
                    r.dist, np.float32(eng_mem.p2p(
                        np.array([a[0]], np.int32),
                        np.array([a[1]], np.int32))[0]))
            else:
                np.testing.assert_array_equal(
                    r.dist, eng_mem.ssd(np.array(a, np.int32))[0])
        solo_cache = solo.store.cache.stats

        # Leg 1 — degenerate fleet: same answers, same counters.
        one, srv1 = _serve_leg(cfg, store_dir, budget, stream, 1, dev)
        for a, b in zip(ref, one):
            np.testing.assert_array_equal(a.dist, b.dist)
        f1 = srv1.fleet_report()
        assert f1 is not None and len(f1.rows) == 1
        for field in ("hits", "misses", "bytes_read", "bytes_filled"):
            got = getattr(f1.cache, field)
            want = getattr(solo_cache, field)
            assert got == want, \
                f"N=1 fleet {field}={got} != unsharded {want} — the " \
                f"routing façade changed cache behavior"

        # Leg 2 — N=2 under a live mesh (the shardlib axis plumbing
        # the serve CLI's --data-parallel uses), with a tracer.
        from ..obs import Tracer, validate_chrome_trace
        tracer = Tracer()
        with distributed(dev) as rank_dev:
            world = dist.get_world_size()
            mesh = sl.make_mesh((world,), ("data",), rank_dev.type)
            with sl.axis_rules(mesh, {"batch": "data"}):
                two, srv2 = _serve_leg(cfg, store_dir, budget, stream, 2,
                                       dev, tracer=tracer)
        for a, b in zip(ref, two):
            np.testing.assert_array_equal(a.dist, b.dist)
        f2 = srv2.fleet_report()
        assert f2 is not None and len(f2.rows) == 2
        for row in f2.rows:
            if row["blocks"] == 0:
                continue
            assert row["hit_rate"] > 0.0, \
                f"shard {row['shard']} owns {row['blocks']} blocks " \
                f"but served with a 0.0 hit rate — per-shard budget " \
                f"split or routing regressed"
        assert sum(r["bytes_read"] for r in f2.rows) == \
            f2.cache.bytes_read, "per-shard bytes don't sum to the " \
            "fleet aggregate"

        doc = tracer.chrome()
        problems = validate_chrome_trace(doc)
        assert not problems, f"fleet trace invalid: {problems[:3]}"
        trace_out = os.environ.get("FLEET_TRACE_OUT")
        if trace_out:
            tracer.write_chrome(trace_out)
            print(f"fleet trace written to {trace_out} "
                  f"({len(doc['traceEvents'])} events)")

        bench_out = os.environ.get("FLEET_BENCH_OUT")
        if bench_out:
            from ..obs.metrics import SCHEMA_VERSION
            doc = {"schema_version": SCHEMA_VERSION,
                   "tables": {"fleet_smoke": [
                       {"shards": n,
                        "hit_rate": fs.cache.hit_rate(),
                        "bytes_read": fs.cache.bytes_read,
                        "per_shard": fs.rows}
                       for n, fs in ((1, f1), (2, f2))]}}
            with open(bench_out, "w") as f:
                json.dump(doc, f, indent=1)
            print(f"fleet bench stats written to {bench_out}")

        print(f"fleet smoke OK on {dev}: {len(stream)} mixed requests, "
              f"unsharded == N=1 == N=2 bit-identical; N=1 counters "
              f"exact (hit rate {f1.cache.hit_rate():.3f}); N=2 "
              f"per-shard hit rates "
              f"{[round(r['hit_rate'], 3) for r in f2.rows]}, "
              f"{f2.cache.bytes_read/1e6:.2f} MB read across "
              f"{len(f2.rows)} shards under a {world}-rank mesh")


if __name__ == "__main__":
    main()
