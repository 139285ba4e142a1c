#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's query path on one GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA H100 (or
any sm_90a card).  It imports only the port (``src/repro_torch``) and
never JAX or the JAX package.  Phases, each of which asserts:

1. environment: the card's name and power limit (nvidia-smi);
2. build: nvcc compiles every kernel source of the port, in parallel;
3. kernels: each hand-written kernel against its plain PyTorch version
   on the card, at the full-size shapes of the query path, required
   bit-equal (``torch.equal``: every operation is an fp32 add or a min),
   with the kernel's and the plain version's times (CUDA events);
4. the slice at full size: the road-network stand-in (grid side 200,
   40,000 nodes), the serve CLI's build config with the closure limit
   raised so the 15,722-node core is closed on the card, and a
   ``QueryServer`` answering 256 seeded SSD requests with repeats.  The
   kernel launch counters are zeroed just before ``serve_stream`` and
   read just after, and must match batches x real plan levels.  Then one
   SSSP batch with paths, one ``bellman``-mode batch, and checks against
   host Dijkstra and against the same engine on the CPU;
5. profile: ``torch.profiler`` over a few SSD batches prints the device
   time by kernel and the device's idle share (no assertion).

It prints one JSON line with every kernel's numbers, the card's name and
power limit, and, last, ``{"ok": true, "device": {...}}``.  Any failure
exits non-zero before those lines; without a card, or outside a
checkout, it exits non-zero at once.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Full-size configuration: the serve CLI's build on the road stand-in.
SIDE = 200
BATCH = 32
REQUESTS = 256
REQUEST_POOL = 160          # distinct sources: repeats hit the row cache
CLOSURE_LIMIT = 16384
CORE = 15722                # core nodes of this build: the minplus shapes
PLAN_F_ROWS = 22400         # plan_f's M_pad: the edge_relax level shape
K_SLOTS = 16

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bandwidth and
# fp32 outside the tensor cores, the unit both kernels run on.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

REPLACES = {
    "edge_relax": "src/repro/kernels/edge_relax/kernel.py:35",
    "tropical_matmul": "src/repro/kernels/tropical_matmul/kernel.py:39",
}


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the fp32 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def time_ms(torch, fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


# ------------------------------------------------------------- phase 3
def check_minplus(torch, card: str, m: int, k: int, n: int,
                  lda_pad: int = 0, timed: bool = True) -> dict:
    from repro_torch.kernels.tropical_matmul import minplus, minplus_ref
    gen = torch.Generator(device="cuda").manual_seed(m * 7919 + k)
    wide = torch.rand((m, k + lda_pad), generator=gen, device="cuda") * 100
    a = wide[:, :k]                      # rows contiguous, lda = k + pad
    b = torch.rand((k, n), generator=gen, device="cuda") * 1000
    a[torch.rand(a.shape, generator=gen, device="cuda") < 0.3] = \
        float("inf")                     # unreached labels
    b[torch.rand(b.shape, generator=gen, device="cuda") < 0.01] = \
        float("inf")                     # unreachable core pairs
    got = minplus(a, b)
    want = minplus_ref(a, b)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        diff = (got != want).sum().item()
        raise AssertionError(f"minplus [{m},{k}]x[{k},{n}]: {diff} "
                             "entries differ from the plain version")
    row = {"shape": f"[{m},{k}]x[{k},{n}]", "max_abs_err": 0.0}
    if timed:
        row["ms"] = time_ms(torch, lambda: minplus(a, b), iters=20)
        row["plain_ms"] = time_ms(torch, lambda: minplus_ref(a, b), iters=3)
        row["bound_ms"], row["bound_by"] = bound(
            4.0 * (m * k + k * n + m * n), 2.0 * m * k * n)
    say(f"minplus {row['shape']} lda={k + lda_pad}: equal to plain"
        + (f"; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
           f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}) on {card}"
           if timed else ""))
    return row


def synthetic_level(np, torch, s: int, n: int, m_pad: int, k: int,
                    seed: int):
    """A level shaped like ``plan_f``'s widest one, built the way a real
    level is: gathered nodes [0, n/2) and written nodes [n/2, n) are
    disjoint; destinations repeat (split in-edge lists); valid rows have
    1..k real slots, the rest sentinel/+inf padding; trailing padding
    rows are invalid; a few invalid rows carry real, winning edges that
    the mask must suppress.  ``dist`` has the sentinel column n."""
    rng = np.random.default_rng(seed)
    n_valid = m_pad - m_pad // 56
    pool = rng.choice(np.arange(n // 2, n), size=n_valid * 5 // 7,
                      replace=False)
    dst = np.full(m_pad, n, np.int32)
    dst[:n_valid] = np.sort(rng.choice(pool, size=n_valid))
    src = np.full((m_pad, k), n, np.int32)
    w = np.full((m_pad, k), np.inf, np.float32)
    real = np.arange(k)[None, :] < rng.integers(1, k + 1, n_valid)[:, None]
    src[:n_valid][real] = rng.integers(0, n // 2, int(real.sum()))
    w[:n_valid][real] = rng.integers(1, 11, int(real.sum()))
    valid = np.zeros(m_pad, bool)
    valid[:n_valid] = True
    masked = rng.choice(n_valid, size=64, replace=False)
    valid[masked] = False
    w[masked, 0] = 0.0
    src[masked, 0] = rng.integers(0, n // 2, 64)
    dist = rng.integers(0, 200, (s, n + 1)).astype(np.float32)
    dist[rng.random((s, n + 1)) < 0.25] = np.inf
    dist[:, n] = np.inf
    to = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    return to(dist), to(dst), to(src), to(w), to(valid)


def check_relax(np, torch, card: str, s: int, n: int, m_pad: int, k: int,
                timed: bool = True) -> dict:
    from repro_torch.kernels.edge_relax import relax_level_, relax_level_ref_
    dist, dst, src, w, valid = synthetic_level(np, torch, s, n, m_pad, k,
                                               seed=m_pad)
    got = relax_level_(dist.clone(), dst, src, w, valid)
    want = relax_level_ref_(dist.clone(), dst, src, w, valid)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        diff = (got != want).sum().item()
        raise AssertionError(f"relax_level_ S={s} M={m_pad} K={k}: {diff} "
                             "entries differ from the plain version")
    if not torch.isinf(got[:, n]).all():
        raise AssertionError("relax_level_ wrote the sentinel column")
    if torch.equal(got, dist):
        raise AssertionError("relax_level_ changed nothing: test level "
                             "is inert")
    row = {"shape": f"S={s} N={n + 1} M={m_pad} K={k}", "max_abs_err": 0.0}
    if timed:
        scratch = dist.clone()
        copy_ms = time_ms(torch, lambda: scratch.copy_(dist), iters=200)
        row["ms"] = time_ms(torch, lambda: relax_level_(
            scratch.copy_(dist), dst, src, w, valid), iters=200) - copy_ms
        row["plain_ms"] = time_ms(torch, lambda: relax_level_ref_(
            scratch.copy_(dist), dst, src, w, valid), iters=20) - copy_ms
        # Bytes: dist read once, the valid rows' plan entries, the
        # written destination columns; ops: an add and a min per slot.
        v = int(valid.sum())
        n_dst = int(torch.unique(dst[valid]).numel())
        row["bound_ms"], row["bound_by"] = bound(
            4.0 * s * (n + 1) + v * (4 + 1 + 8 * k) + 4.0 * s * n_dst,
            2.0 * s * v * k)
    say(f"relax_level_ {row['shape']}: equal to plain"
        + (f"; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
           f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}) on {card}"
           if timed else ""))
    return row


# ------------------------------------------------------------- phase 4
def drive_slice(np, torch, card: str, side: int, closure_limit: int,
                dev: str = "cuda") -> dict:
    from repro_torch.core import (BuildConfig, QueryEngine, build_hod_fast,
                                  dijkstra_reference, grid_road_graph,
                                  pack_index)
    from repro_torch.kernels.edge_relax import relax_level_
    from repro_torch.kernels.tropical_matmul import minplus
    from repro_torch.launch.serve import QueryServer

    g = grid_road_graph(side, seed=0)
    t0 = time.perf_counter()
    res = build_hod_fast(g, BuildConfig(max_core_nodes=512,
                                        max_core_edges=1 << 15))
    t1 = time.perf_counter()
    ix = pack_index(g, res, chunk=2048, k_cap=K_SLOTS,
                    closure_limit=closure_limit, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    eng = QueryEngine(ix, device=dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    say(f"graph n={g.n} m={g.m}; core {ix.n_core} nodes, "
        f"{ix.core_dst.shape[0]} edges; plan_f {list(ix.plan_f.w.shape)} "
        f"plan_b {list(ix.plan_b.w.shape)} "
        f"plan_core {list(ix.plan_core.w.shape)}; core_mode "
        f"{eng.core_mode}")
    say(f"build {t1 - t0:.2f} s (host), pack+closure {t2 - t1:.2f} s "
        f"(closure on the card), upload {t3 - t2:.2f} s, on {card}")
    if eng.core_mode != "closure":
        raise AssertionError("the full-size index must serve in closure "
                             "mode (raise closure_limit)")

    server = QueryServer(eng, batch_size=BATCH, warm_start=True)
    rng = np.random.default_rng(0)
    pool = rng.choice(g.n, size=REQUEST_POOL, replace=False)
    requests = rng.choice(pool, size=REQUESTS).astype(np.int32)

    torch.cuda.reset_peak_memory_stats()
    relax_level_.launches = 0
    minplus.launches = 0
    t0 = time.perf_counter()
    results = server.serve_stream(requests)
    wall = time.perf_counter() - t0
    launches = {"edge_relax": relax_level_.launches,
                "tropical_matmul": minplus.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    st = server.stats
    levels = ix.plan_f.n_real_levels + ix.plan_b.n_real_levels
    say(f"served {st.requests} SSD requests in {st.batches} batches, "
        f"{st.cache_hits} cache hits, {st.padded_slots} padded slots; "
        f"launches {launches} (real levels f+b = {levels})")
    if launches["edge_relax"] != st.batches * levels:
        raise AssertionError(f"edge_relax launched {launches['edge_relax']}"
                             f" times, expected {st.batches} x {levels}")
    if launches["tropical_matmul"] < st.batches or st.batches == 0:
        raise AssertionError("tropical_matmul launched fewer times than "
                             "there were closure batches")
    if st.cache_hits == 0:
        raise AssertionError("the request stream never hit the row cache")
    lat = np.array([r.latency_s for r in results]) * 1e3
    say(f"SSD serving: {st.requests / wall:.1f} q/s over {wall:.3f} s, "
        f"latency p50 {np.percentile(lat, 50):.3f} ms p99 "
        f"{np.percentile(lat, 99):.3f} ms, peak device memory "
        f"{peak_gb:.3f} GB, on {card}")

    by_src = {}
    for r in results:
        if r.dist.shape != (g.n,) or not np.isfinite(r.dist).all():
            raise AssertionError(f"source {r.source}: bad answer row")
        by_src.setdefault(r.source, r.dist)
    check = sorted(by_src)[:4]
    want = dijkstra_reference(g, check).astype(np.float32)
    for i, s in enumerate(check):
        np.testing.assert_array_equal(by_src[s], want[i])
    say(f"SSD rows of sources {check} equal host Dijkstra")

    batch = np.asarray(sorted(by_src)[:BATCH], dtype=np.int32)
    t0 = time.perf_counter()
    d_gpu, p_gpu = eng.sssp(batch)
    sssp_s = time.perf_counter() - t0
    ssd_gpu = eng.ssd(batch)
    np.testing.assert_array_equal(d_gpu, ssd_gpu)
    targets = rng.choice(g.n, size=4).astype(np.int32)
    paths = eng.paths(batch[:4], targets)
    for s, t, path in zip(batch[:4].tolist(), targets.tolist(), paths):
        if path is None or path[0] != s or path[-1] != t:
            raise AssertionError(f"path {s}->{t}: {path}")
        length = 0.0
        for u, v in zip(path, path[1:]):
            dsts, ws = g.out_edges(u)
            hit = np.flatnonzero(dsts == v)
            if not hit.size:
                raise AssertionError(f"path {s}->{t} uses non-edge {u}->{v}")
            length += float(ws[hit[0]])
        if np.float32(length) != d_gpu[list(batch).index(s), t]:
            raise AssertionError(f"path {s}->{t} length {length} is not "
                                 "the distance")
    say(f"SSSP batch of {len(batch)} in {sssp_s * 1e3:.1f} ms (host clock, "
        f"on {card}); 4 paths valid and tight")

    t0 = time.perf_counter()
    d_cpu, p_cpu = QueryEngine(ix, device="cpu").sssp(batch)
    np.testing.assert_array_equal(d_gpu, d_cpu)
    np.testing.assert_array_equal(p_gpu, p_cpu)
    say(f"CUDA engine ssd/sssp equal the CPU engine on {len(batch)} "
        f"sources (CPU run {time.perf_counter() - t0:.1f} s)")

    bell = QueryEngine(ix, core_mode="bellman", device=dev)
    minplus.launches = 0
    t0 = time.perf_counter()
    d_bell = bell.ssd(batch)
    bell_s = time.perf_counter() - t0
    np.testing.assert_array_equal(d_bell, ssd_gpu)
    say(f"bellman batch equals closure: {minplus.launches} min-plus rounds "
        f"in {bell_s * 1e3:.1f} ms (host clock, on {card})")
    if dev == "cuda":
        profile_ssd(torch, eng, batch, card)
    return launches


def profile_ssd(torch, eng, batch, card: str, reps: int = 8) -> None:
    """Where an SSD batch's time goes: device time by kernel, and the
    share of the wall time the device sits idle (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    eng.ssd(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            eng.ssd(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []      # device-side events only: kernels and copies
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0 and e.device_type != DeviceType.CPU:
            rows.append((us, e.count, e.key))
    busy_us = sum(us for us, _, _ in rows)
    if not rows:
        say("profile: the profiler saw no device time (not measured)")
        return
    say(f"profile of {reps} SSD batches of {len(batch)}: wall "
        f"{wall_us / reps / 1e3:.3f} ms/batch, device busy "
        f"{busy_us / reps / 1e3:.3f} ms/batch, device idle share "
        f"{1 - busy_us / wall_us:.3f} (host clock under the profiler, "
        f"on {card})")
    for us, count, key in sorted(rows, reverse=True)[:10]:
        say(f"  {us / reps:9.1f} us/batch  {count // reps:4d} calls/batch  "
            f"{key[:90]}")


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device visible: chip_smoke.py needs one GPU",
              file=sys.stderr)
        return 2
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    card = card_line()
    say(card)
    say(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build()
    say(f"built kernels {list(_build.KERNELS)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                say(f"  {name}: {line.strip()}")

    rows = {
        "tropical_matmul": check_minplus(torch, card, BATCH, CORE, CORE),
        "edge_relax": check_relax(np, torch, card, BATCH, 2 * 20000,
                                  PLAN_F_ROWS, K_SLOTS),
    }
    check_minplus(torch, card, 37, 1001, 777, lda_pad=13, timed=False)
    check_relax(np, torch, card, 45, 998, 301, 5, timed=False)

    launches = drive_slice(np, torch, card, SIDE, CLOSURE_LIMIT)
    if "jax" in sys.modules or any(m == "repro" or m.startswith("repro.")
                                   for m in sys.modules):
        raise AssertionError("the smoke imported jax or the JAX package")

    kernels = []
    for name, src in (("edge_relax", "edge_relax.cu"),
                      ("tropical_matmul", "tropical_matmul.cu")):
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "shape": r["shape"]})
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
