#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving paths on one GPU and check them.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA H100 (or
any sm_90a card).  It imports only the port (``src/repro_torch``) and
never JAX or the JAX package.  Phases, each of which asserts:

1. environment: the card's name and power limit (nvidia-smi);
2. build: nvcc compiles every kernel source of the port, in parallel;
3. kernels: each hand-written kernel against its plain PyTorch version
   on the card, at the full-size shapes of the serving paths, with the
   kernel's, the plain version's and (where one PyTorch call computes
   the same function) the library call's times (CUDA events), ptxas'
   registers and spills of every kernel (none may spill in the two
   redesigned split passes nor in the sweep kernel).  The HoD kernels
   and ``bag_sum`` must be bit-equal (``torch.equal``: fp32 adds and
   mins, or sums in the plain version's order); ``flash_decode`` within
   atol 1e-4 of its f32 output.  The split kernels' edge cases run at
   full width too (M 1 and 33, K below a tile and below the split
   count, ragged K with a short last chunk, a strided and offset ``a``,
   all-+inf rows and columns; kv_len 1 and mid-tile, short last splits,
   f32 and bf16 q).  ``edge_relax`` runs on the served index's real
   levels (built first, as in phase 4): each whole sweep in one launch
   and the widest forward level alone, timed at S = 32 and checked at
   S = 1, 7, 32, 33, 64 and 128, plus two synthetic levels with split
   and masked rows;
4. the HoD slice at full size: the road-network stand-in (grid side 200,
   40,000 nodes), the serve CLI's build config with the closure limit
   raised so the 15,722-node core is closed on the card, and a
   ``QueryServer`` answering 256 seeded SSD requests with repeats.  The
   kernel launch counters are zeroed just before ``serve_stream`` and
   read just after: ``edge_relax`` must launch twice a batch (one sweep
   each way).  Then one SSSP batch with paths, one ``bellman``-mode
   batch, checks against host Dijkstra and against the same engine on
   the CPU, and a ``torch.profiler`` pass over a few SSD batches
   (device time by kernel, the device's idle share; no assertion);
5. the same index served from its block store: ``save_store`` with the
   raw, delta and f16 codecs into a temporary directory (removed at the
   end), then phase 4's request stream through
   ``QueryServer(store_path=...)`` on the card at page-cache budgets of
   5% and 25% of the decompressed segments (raw), 25% (delta, f16), at
   queue depth 4, and the raw 25% run again at depth 1.  Each run's
   answers, cache hits and padded slots must equal phase 4's,
   ``edge_relax`` must launch once a streamed level, ``tropical_matmul``
   at least once a batch, and the device must meter the cache's bytes;
   the hit rate must be below 1 at 5% and above 0 at 25%, delta must
   read fewer bytes than raw, and depth 1 must equal depth 4 in answers
   and counters.  One batch of each other query equals the in-memory
   engine, and a profile of streamed batches follows;
8. the serving front end at full width, after phase 5 and on its
   engine and raw store: ``configs/serve_mixed.yaml`` (ssd:p2p = 1:3,
   400 requests at 400 req/s Poisson, batch 16, ``max_wait_ms`` 60, ssd
   deadline 200 ms, p2p 60 ms with a class batch of 8) through
   ``server_from_config`` and the serve CLI's ``_open_loop`` over
   ``mixed_request_stream``: in memory under ``slo`` and under
   ``fifo``, and from the raw store at 25% under ``slo``.  Every
   future must resolve to phase 4's engine's answer, bit for bit, and
   ``slo_report`` must hold the ``ssd``, ``p2p`` and ``p2p.cached``
   classes (per-class p50/p99 and misses printed).  Then the tracer as
   a pure observer: phase 4's stream served closed-loop with a
   ``Tracer`` and without, in memory and from the raw store at 25%,
   must give the same answers, ``ServerStats``, ``CacheStats`` and
   ``IOStats``, a trace that ``validate_chrome_trace`` accepts, the
   whole span taxonomy from the store, and the same query-thread
   sequence at queue depths 1 and 4 (traced and untraced q/s over warm
   passes printed, not asserted).  Last, the paper's closeness
   application: ``topk_closeness(k=10)`` over 2,048 seeded candidates
   in memory and from the store (bounded sweeps) must agree in nodes
   and farness, and ``estimate_closeness(eps=0.1, batch_size=64)``
   runs in memory;
9. the fleet and the paper's baselines, after phase 8 and on phase 5's
   raw and delta stores: phase 4's request stream through
   ``QueryServer(store_path=..., shards=N)`` at N = 1, 2 and 4, a
   fleet-wide budget of 25% and queue depth 4.  Each run holds phase
   5's checks (answers, cache hits and padded slots equal phase 4's,
   one ``edge_relax`` launch a streamed level); at N = 1 the aggregate
   ``CacheStats`` and ``IOStats`` must equal phase 5's unsharded run of
   the same codec counter for counter; the per-shard bytes read must
   sum to the fleet's; at N = 2 every shard that owns blocks must hit;
   and no run of more than one shard may read more bytes than the
   1-shard run.  Then ``configs/serve_fleet.yaml`` (ssd:p2p 1:3,
   ``slo``, delta, 2 shards) through ``server_from_config`` and
   ``_open_loop``: every future resolves to phase 4's answer.  Then
   the paper's baselines: ``em_dijkstra`` from 4 of phase 4's sources
   on the side-200 graph, within rtol 1e-5 of phase 4's fp32 answers,
   its modeled I/O a query beside a cold HoD query's (the raw 1-shard
   fleet's page cache emptied first); ``VCIndex`` and the reference
   builder ``build_hod`` on a side-31 grid, the ``build_hod`` index
   served on the card and equal to host Dijkstra;
6. LM serving at full width: first glm4-9b's width at 2 layers in f32,
   whose decode must equal prefill of the extended sequences at atol
   1e-4 (the logic); then all 40 layers, random bf16 weights (18.8 GB)
   from a seeded generator.  (a) 4 prompts of 512 tokens are prefilled
   into a 1024-slot cache and decoded greedily for 32 steps; the last
   step's logits must match a prefill of the extended sequences within
   a relative L2 bound (LM_REL_L2), and the last step re-run with each
   of four planted faults must land outside it (the check's controls);
   (b) decode_32k with its batch cut from 128 to 32 (the 128-row cache
   is 172 GB): 42.9 GB of KV filled from the generator, 8 timed decode
   steps at cur_len 32760, and one ``torch.profiler`` pass over a step.
   ``flash_decode`` must launch 40 times a step in each run;
7. DLRM serving at full size: rm2 with 26 x 10^6-row tables (6.66 GB);
   ``forward`` at serve_p99 (B=512) and serve_bulk (B=262,144), and
   ``retrieval_scores`` over 10^6 candidates, checked against the same
   model on the CPU, and one profile of a serve_bulk call; ``bag_sum``
   must launch once a call.

Each path frees its memory before the next.  Every launch counter is
zeroed just before a served run and read just after it.  It prints one
JSON line with every kernel's numbers (``launches`` is the count of the
run at the kernel's timed shape, ``launches_by_path`` each served run's
own count, phase 8's paths ``hod_mixed_slo``,
``hod_store_mixed_slo`` and ``hod_topk_store`` and phase 9's
``hod_fleet_raw`` and ``hod_fleet_delta`` (each the sum over its runs
at 1, 2 and 4 shards) and ``hod_fleet_mixed_slo`` included), the card's
name and power limit, and, last,
``{"ok": true, "device": {...}}``.  Any failure
exits non-zero before those lines; without a card, or outside a
checkout, it exits non-zero at once.
"""
import json
import shutil
import subprocess
import sys
import tempfile
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
PLAN_F_ROWS = 22400         # plan_f's M_pad: the synthetic level's shape
K_SLOTS = 16

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bandwidth and
# dense bf16 on the tensor cores (flash_decode's products over bf16
# caches).  The data sheet's 67 TFLOP/s of fp32 counts an FMA as two
# operations; the SIMT kernels here (min-plus, edge relaxation, bag_sum)
# do no FMA, and each add, multiply or min is one instruction on one of
# the SM's 128 fp32 lanes.  Their rate is SMs x 128 x the SM's maximum
# clock, read from the card (fp32_instr_per_s): 132 x 128 x 1.98 GHz =
# 33.45e12 on an H100 SXM.
HBM_BYTES_PER_S = 3.35e12
BF16_TC_OPS_PER_S = 989e12
FP32_LANES_PER_SM = 128

# LM serving: glm4-9b; decode_32k's batch cut from 128 to 32.
LM_PROMPTS, LM_PROMPT_LEN, LM_SERVE_CACHE, LM_SERVE_STEPS = 4, 512, 1024, 32
DECODE_BATCH, DECODE_CUR, DECODE_STEPS = 32, 32760, 8
# Decode-vs-prefill logits bound at 40 layers in bf16, as a relative L2
# error ||decode - prefill|| / ||prefill|| over the last step's logits
# (tests/test_torch_transformer.py holds 2 layers to 2e-2).  It lies
# between the sound reading (1.924e-2) and the smallest reading of the
# planted faults that lm_check_controls re-runs every time (3.130e-2,
# the self-token dropped), near their geometric mean (PERF.md §6).
# Greedy tokens must agree wherever the reference's top-two gap exceeds
# twice the largest logit error (noise cannot flip those).  An f32 run of
# the same width at 2 layers checks the decode logic itself at the CPU
# test's f32 tolerance, atol 1e-4.
LM_REL_L2, LM_F32_ATOL = 2.5e-2, 1e-4
# flash_decode's check: the per-layer decode_32k shape
FD_B, FD_H, FD_KH, FD_DH, FD_S = 32, 32, 2, 128, 32768
# DLRM rm2: 26 tables of 10^6 rows; serve_bulk's lookups
RM2_ROWS, RM2_DIM, BULK_BAGS = 26 * 10 ** 6, 64, 262144 * 26

# Phase 5: the phase 4 index saved as a block store with each codec, and
# phase 4's request stream served from it at page-cache budgets of 5% and
# 25% of the decompressed segments, at queue depths 4 and 1.
STORE_CODECS = ("raw", "delta", "f16")
STORE_RUNS = (("raw", 0.05, 4), ("raw", 0.25, 4), ("delta", 0.25, 4),
              ("f16", 0.25, 4), ("raw", 0.25, 1))

# Phase 8: the serving front end. The mixed config, top-k closeness over
# a seeded candidate set, closeness estimation, and the warm passes of
# the tracer's q/s comparison.
MIXED_CONFIG = "configs/serve_mixed.yaml"
TOPK_K, TOPK_CANDIDATES = 10, 2048
CLOSENESS_EPS, CLOSENESS_BATCH = 0.1, 64
OVERHEAD_PASSES = 5

# Phase 9: the fleet over phase 5's raw and delta stores, the fleet
# config, and the paper's baselines (EM-Dijk from a few of phase 4's
# sources; VC-Index and the reference builder on a smaller grid, odd so
# that VC-Index's matching leaves a node out).
FLEET_SHARDS, FLEET_FRAC, FLEET_DEPTH = (1, 2, 4), 0.25, 4
FLEET_CONFIG = "configs/serve_fleet.yaml"
EM_SOURCES, EM_RTOL = 4, 1e-5
BASELINE_SIDE, VC_TOP_NODES = 31, 256

# The served run whose launch count the kernels line reports: the one at
# the shape each kernel is timed at.
MAIN_PATH = {"edge_relax": "hod_serve_stream",
             "tropical_matmul": "hod_serve_stream",
             "flash_decode": "decode_32k", "embedding_bag": "serve_bulk"}

REPLACES = {
    "edge_relax": "src/repro/kernels/edge_relax/kernel.py:35",
    "tropical_matmul": "src/repro/kernels/tropical_matmul/kernel.py:39",
    "flash_decode": "src/repro/kernels/flash_decode/kernel.py:87",
    "embedding_bag": "src/repro/kernels/embedding_bag/kernel.py:20",
}


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def fp32_instr_per_s(torch) -> "tuple[float, float]":
    """(fp32 instructions a second on the SIMT lanes, the SM clock in
    MHz it assumes): SMs x 128 lanes x the card's maximum SM clock."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * FP32_LANES_PER_SM * mhz * 1e6, mhz


# Set by main() from the card before any bound is computed or any
# queued timing held: the SIMT instruction rate and the SM's maximum
# clock in Hz.
FP32_INSTR_PER_S = SM_HZ = None


def bound(nbytes: float, ops: float, ops_per_s: float = None):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the peak rate of their type (by default one fp32
    instruction an operation, FP32_INSTR_PER_S)."""
    ops_per_s = ops_per_s or FP32_INSTR_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def ptxas_report(log: str) -> dict:
    """Per kernel entry function in an ``nvcc -Xptxas -v`` log: registers,
    static shared memory and spill bytes (dynamic shared memory is set at
    launch and reported by each wrapper's device_config)."""
    import re
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            fn = m.group(1)
            out.setdefault(fn, {"registers": None, "smem": 0,
                                "spill_stores": 0, "spill_loads": 0})
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[fn]["spill_stores"] = int(m.group(1))
            out[fn]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[fn]["smem"] = int(m.group(1)) if m else 0
    return {fn: i for fn, i in out.items() if i["registers"] is not None}


def time_ms(torch, fn, iters: int, warmup: int = 1,
            queued: bool = False) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events after warm-up.
    ``queued``: a sleep kernel holds the card (1 ms a run) while the host
    queues the runs, so that a kernel shorter than its launch's host
    cost is timed on the device and not paced by the host; raises if the
    host took longer than the hold."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    hold_ms = float(iters) if queued else 0.0
    if queued:
        torch.cuda._sleep(int(hold_ms * 1e-3 * SM_HZ))
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if queued and host_ms > 0.9 * hold_ms:
        raise AssertionError(f"queued timing: the host took {host_ms:.1f} "
                             f"ms to queue what a {hold_ms:.0f} ms hold "
                             "covers")
    return start.elapsed_time(stop) / iters


# ------------------------------------------------------------- phase 3
def minplus_inputs(torch, m: int, k: int, n: int, lda_pad: int = 0,
                   offset: int = 0):
    """a [m, k] as a column slice (lda = k + offset + lda_pad, starting at
    column ``offset``, like the label state's core block) and b [k, n],
    with unreached labels and unreachable pairs at +inf, one all-+inf row
    of a (when m > 1), a row that is +inf but for its last entry, and two
    all-+inf columns of b."""
    gen = torch.Generator(device="cuda").manual_seed(m * 7919 + k)
    wide = torch.rand((m, k + offset + lda_pad), generator=gen,
                      device="cuda") * 100
    a = wide[:, offset:offset + k]
    b = torch.rand((k, n), generator=gen, device="cuda") * 1000
    a[torch.rand(a.shape, generator=gen, device="cuda") < 0.3] = \
        float("inf")                     # unreached labels
    b[torch.rand(b.shape, generator=gen, device="cuda") < 0.01] = \
        float("inf")                     # unreachable core pairs
    a[0] = float("inf")
    a[0, k - 1] = 1.0
    if m > 1:
        a[m - 1] = float("inf")
    b[:, n // 3] = float("inf")
    b[:, n - 1] = float("inf")
    return a, b


def check_minplus(torch, card: str, m: int, k: int, n: int,
                  lda_pad: int = 0, offset: int = 0, n_k: int = None,
                  timed: bool = True) -> dict:
    """The kernel bit-equal (torch.equal) to the plain version; ``n_k``
    forces the number of K chunks.  Timed: the wrapper's whole call, the
    plain version, and the bound."""
    from repro_torch.kernels.tropical_matmul import minplus, minplus_ref
    from repro_torch.kernels.tropical_matmul import ops as mp_ops
    a, b = minplus_inputs(torch, m, k, n, lda_pad, offset)
    got = minplus(a, b) if n_k is None else mp_ops._launch(a, b, n_k=n_k)
    want = minplus_ref(a, b)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        diff = (got != want).sum().item()
        raise AssertionError(f"minplus [{m},{k}]x[{k},{n}] n_k={n_k}: {diff} "
                             "entries differ from the plain version")
    sms, per_sm, smem = mp_ops.device_config(a.device)
    plan = mp_ops.plan_split_k(m, n, k, sms, per_sm)
    lda = a.stride(0)
    va, vb = mp_ops.copy_widths(n, k, lda, a.data_ptr(), b.data_ptr())
    row = {"shape": f"[{m},{k}]x[{k},{n}]", "max_abs_err": 0.0,
           "plan": f"{plan.n_k} chunks of {plan.chunk}, {plan.blocks} "
                   f"blocks in {plan.waves} waves of {sms} x {per_sm}"}
    if timed:
        row["ms"] = time_ms(torch, lambda: minplus(a, b), iters=20)
        row["plain_ms"] = time_ms(torch, lambda: minplus_ref(a, b), iters=3)
        row["bound_ms"], row["bound_by"] = bound(
            4.0 * (m * k + k * n + m * n), 2.0 * m * k * n)
    say(f"minplus {row['shape']} lda={lda} copies {va}/{vb} B"
        + (f", forced {n_k} chunks" if n_k else f", {row['plan']}")
        + ": equal to plain"
        + (f"; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
           f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
           f"{smem} B shared a block, on {card}" if timed else ""))
    return row


def check_minplus_edges(torch, card: str) -> None:
    """The split-K edge cases at the core search's full width (N = C)."""
    for m, k, n, pad, off, n_k in (
            (1, CORE, CORE, 0, 0, None),         # M = 1
            (33, CORE, CORE, 0, 0, None),        # M = 33: two row tiles
            (BATCH, 5, CORE, 0, 0, None),        # K below one tile
            (BATCH, 5, CORE, 0, 0, 16),          # K below the split count
            (BATCH, 1001, CORE, 0, 0, 7),        # ragged K, short chunk
            (BATCH, CORE, CORE, 3, 24279, None),  # strided, offset a
            (37, 1001, 777, 13, 0, None)):
        check_minplus(torch, card, m, k, n, pad, off, n_k, timed=False)


def synthetic_level(np, torch, s: int, n: int, m_pad: int, k: int,
                    seed: int):
    """A bucketed level built the way a real level is: gathered nodes
    [0, n/2) and written nodes [n/2, n) are disjoint; destinations repeat
    (split in-edge lists); valid rows have 1..k real slots, the rest
    sentinel/+inf padding; trailing padding rows are invalid; a few
    invalid rows carry real, winning edges that the packer must drop.
    ``dist`` is node-major [n + 1, s] on the card, with the sentinel
    node n; the level's arrays stay on the host, to be packed."""
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
    masked = rng.choice(n_valid, size=min(64, n_valid), replace=False)
    valid[masked] = False
    w[masked, 0] = 0.0
    src[masked, 0] = rng.integers(0, n // 2, masked.size)
    dist = rng.integers(0, 200, (n + 1, s)).astype(np.float32)
    dist[rng.random((n + 1, s)) < 0.25] = np.inf
    dist[n] = np.inf
    return torch.from_numpy(dist).cuda(), (dst, src, w, valid)


def check_relax_equal(torch, dist, sweep, what: str,
                      must_change: bool = True) -> None:
    """``relax_sweep_`` on the card bit-equal (torch.equal) to its plain
    version on the same card, the sentinel node left +inf, and (unless
    not ``must_change``) some label changed: the case is not inert."""
    from repro_torch.kernels.edge_relax import relax_sweep_, relax_sweep_ref_
    got = relax_sweep_(dist.clone(), sweep)
    want = relax_sweep_ref_(dist.clone(), sweep)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        diff = (got != want).sum().item()
        raise AssertionError(f"relax_sweep_ {what}: {diff} labels differ "
                             "from the plain version")
    if not torch.isinf(got[sweep.n_nodes - 1]).all():
        raise AssertionError(f"relax_sweep_ {what} wrote the sentinel node")
    if must_change and torch.equal(got, dist):
        raise AssertionError(f"relax_sweep_ {what} changed nothing: the "
                             "case is inert")


def check_relax_synthetic(np, torch, s: int, n: int, m_pad: int,
                          k: int) -> None:
    """A synthetic level (split rows, masked winning rows) as a one-level
    sweep: a correctness case."""
    from repro_torch.kernels.edge_relax import pack_sweep
    dist, level = synthetic_level(np, torch, s, n, m_pad, k, seed=m_pad)
    check_relax_equal(torch, dist, pack_sweep([level], n + 1, "cuda"),
                      f"synthetic S={s} N={n + 1} M={m_pad} K={k}")
    say(f"relax_sweep_ synthetic level S={s} N={n + 1} M={m_pad} K={k}: "
        "equal to plain")


def sweep_bound(torch, sweep, s: int):
    """(bytes, operations, L2 bytes) of a sweep.  Bytes: what it must
    move from device memory, all its state fitting in L2 (5.1 MB at
    N = 40,001, S = 32; L2 is 50 MB): its CSR once (level pointer and
    ways, a row's destination and pointer, a slot's source and weight,
    4 bytes each), the S labels of each distinct node it reads (a
    source, or a destination's old labels) read once, and those of each
    distinct node it writes written once.  Operations: an add and a min
    a slot and label.  L2 bytes, a figure with no rate attached: the
    same summed level by level (each level's CSR, the labels of the
    distinct nodes it reads, the labels it writes read and written),
    the traffic that stays in L2 between levels."""
    r, e, n_lv = sweep.level_rows, sweep.level_slots, sweep.n_levels
    rows, slots = r[-1] - r[0], e[-1] - e[0]
    src = sweep.src[e[0]:e[-1]]
    dst = sweep.row_dst[r[0]:r[-1]]
    read = int(torch.unique(torch.cat([src, dst])).numel())
    written = int(torch.unique(dst).numel())
    csr = 4 * (2 * n_lv + 1) + 8 * rows + 4 + 8 * slots
    nbytes = csr + 4 * s * (read + written)
    l2 = 0
    for i in range(n_lv):
        reads = int(torch.unique(sweep.src[e[i]:e[i + 1]]).numel())
        l2 += 8 * (r[i + 1] - r[i]) + 8 * (e[i + 1] - e[i]) \
            + 4 * s * (reads + 2 * (r[i + 1] - r[i]))
    return nbytes, 2 * s * slots, l2


def check_relax_sweeps(np, torch, card: str, ix) -> dict:
    """``edge_relax`` on the served index's real levels: each whole sweep
    (plan_f, plan_b: one launch each, as a served SSD batch runs them),
    the widest forward level alone as a one-level sweep, and a sweep of
    8 one-row levels (the floor a level costs), each bit-equal to the
    plain version at S = 32 and at the edge widths 1, 7, 33, 64 and 128,
    and timed at S = 32 beside its bound and the plain
    version (CUDA events, the runs queued behind a hold so the host's
    launch cost does not pace them; the restore copy of the labels is
    timed alone and subtracted).  Returns the kernels line's row: one
    batch's two sweeps."""
    from repro_torch.core.query import _plan_sweep
    from repro_torch.kernels.edge_relax import relax_sweep_, relax_sweep_ref_
    from repro_torch.kernels.edge_relax.ops import (device_config,
                                                    plan_sweep_launch)
    from repro_torch.kernels.edge_relax import pack_sweep
    f = _plan_sweep(ix.plan_f, ix.n_pad, "cuda")
    b = _plan_sweep(ix.plan_b, ix.n_pad, "cuda")
    widest = int(np.argmax(f.level_widths))
    # The floor of a level: 8 levels of one row and one slot each (node
    # i + 1 from node i), the dependent loads and the grid barrier alone.
    chain = pack_sweep([(np.array([i + 1], np.int32),
                         np.array([[i]], np.int32),
                         np.array([[1.0]], np.float32), np.array([True]))
                        for i in range(8)], ix.n_pad, "cuda")
    sweeps = {"plan_f": f, "plan_b": b,
              f"plan_f level {widest}": f.level(widest),
              "8 one-row levels": chain}
    gen = torch.Generator(device="cuda").manual_seed(14)

    def labels(s):
        d = torch.randint(0, 200, (ix.n_pad, s), generator=gen,
                          device="cuda").float()
        d[torch.rand(d.shape, generator=gen, device="cuda") < 0.25] = \
            float("inf")
        d[ix.n] = float("inf")
        return d

    for s in (1, 7, 33, 64, 128):
        dist = labels(s)
        for name in ("plan_f", "plan_b"):
            check_relax_equal(torch, dist, sweeps[name], f"{name} S={s}")
    say("relax_sweep_ served sweeps at S = 1, 7, 33, 64, 128: equal to "
        "plain")
    dist = labels(BATCH)
    scratch = dist.clone()
    copy_ms = time_ms(torch, lambda: scratch.copy_(dist), iters=200,
                      queued=True)
    sms, threads, per_sm = device_config(dist.device)
    parts = {}
    for name, sw in sweeps.items():
        check_relax_equal(torch, dist, sw, f"{name} S={BATCH}",
                          must_change=sw is not chain)
        plan = plan_sweep_launch(BATCH, True, sw.level_widths,
                                 sw.level_max_slots, threads, sms * per_sm)
        nbytes, ops, l2 = sweep_bound(torch, sw, BATCH)
        part = {"levels": sw.n_levels, "rows": sw.level_rows[-1]
                - sw.level_rows[0], "slots": sw.level_slots[-1]
                - sw.level_slots[0], "bytes": nbytes, "ops": ops,
                "l2_bytes": l2,
                "grid": f"{plan.blocks} blocks of {threads}, "
                        f"{plan.lanes} lanes a row, ways {list(plan.ways)}"}
        part["ms"] = time_ms(torch, lambda: relax_sweep_(
            scratch.copy_(dist), sw), iters=200, queued=True) - copy_ms
        part["plain_ms"] = time_ms(torch, lambda: relax_sweep_ref_(
            scratch.copy_(dist), sw), iters=10) - copy_ms
        part["bound_ms"], part["bound_by"] = bound(nbytes, ops)
        parts[name] = part
        say(f"relax_sweep_ {name}: {part['levels']} levels, "
            f"{part['rows']} rows, {part['slots']} slots, {part['grid']}; "
            f"equal to plain; kernel {part['ms']:.4f} ms, plain "
            f"{part['plain_ms']:.4f} ms, bound {part['bound_ms']:.4f} ms "
            f"({part['bound_by']}; {nbytes} B from memory, {l2} B level "
            f"by level in L2) on {card}")
    batch = [parts["plan_f"], parts["plan_b"]]
    row = {"shape": f"plan_f + plan_b sweeps of one SSD batch (2 "
                    f"launches), S={BATCH}, N={ix.n_pad}",
           "max_abs_err": 0.0, "parts": parts,
           "ms": sum(p["ms"] for p in batch),
           "plain_ms": sum(p["plain_ms"] for p in batch)}
    row["bound_ms"], row["bound_by"] = bound(
        sum(p["bytes"] for p in batch), sum(p["ops"] for p in batch))
    say(f"relax_sweep_ one batch's sweeps: kernel {row['ms']:.4f} ms, "
        f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}) on {card}")
    return row


# ------------------------------------------------------------- phase 4
def served_index(torch, card: str, side: int, closure_limit: int):
    """The serve CLI's build on the road stand-in, with the core closed
    on the card: (graph, index)."""
    from repro_torch.core import (BuildConfig, build_hod_fast,
                                  grid_road_graph, pack_index)
    g = grid_road_graph(side, seed=0)
    t0 = time.perf_counter()
    res = build_hod_fast(g, BuildConfig(max_core_nodes=512,
                                        max_core_edges=1 << 15))
    t1 = time.perf_counter()
    ix = pack_index(g, res, chunk=2048, k_cap=K_SLOTS,
                    closure_limit=closure_limit, device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    say(f"graph n={g.n} m={g.m}; core {ix.n_core} nodes, "
        f"{ix.core_dst.shape[0]} edges; plan_f {list(ix.plan_f.w.shape)} "
        f"plan_b {list(ix.plan_b.w.shape)} "
        f"plan_core {list(ix.plan_core.w.shape)}; real levels "
        f"{ix.plan_f.n_real_levels} + {ix.plan_b.n_real_levels}")
    say(f"build {t1 - t0:.2f} s (host), pack+closure {t2 - t1:.2f} s "
        f"(closure on the card), on {card}")
    return g, ix


def drive_slice(np, torch, card: str, g, ix, dev: str = "cuda") -> dict:
    """Phase 4: the in-memory server and engine at full size.  Returns
    the served run's ``launches``, ``requests``, ``results`` and
    ``stats``, and the ``engine`` (phase 5 holds the store to them)."""
    from repro_torch.core import QueryEngine, dijkstra_reference
    from repro_torch.kernels.edge_relax import relax_sweep_
    from repro_torch.kernels.tropical_matmul import minplus
    from repro_torch.launch.serve import QueryServer

    t0 = time.perf_counter()
    eng = QueryEngine(ix, device=dev)
    torch.cuda.synchronize()
    say(f"engine upload and sweep packing {time.perf_counter() - t0:.2f} "
        f"s; core_mode {eng.core_mode}, on {card}")
    if eng.core_mode != "closure":
        raise AssertionError("the full-size index must serve in closure "
                             "mode (raise closure_limit)")

    server = QueryServer(eng, batch_size=BATCH, warm_start=True)
    rng = np.random.default_rng(0)
    pool = rng.choice(g.n, size=REQUEST_POOL, replace=False)
    requests = rng.choice(pool, size=REQUESTS).astype(np.int32)

    torch.cuda.reset_peak_memory_stats()
    relax_sweep_.launches = 0
    minplus.launches = 0
    t0 = time.perf_counter()
    results = server.serve_stream(requests)
    wall = time.perf_counter() - t0
    launches = {"edge_relax": relax_sweep_.launches,
                "tropical_matmul": minplus.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    st = server.stats
    say(f"served {st.requests} SSD requests in {st.batches} batches, "
        f"{st.cache_hits} cache hits, {st.padded_slots} padded slots; "
        f"launches {launches} (one edge_relax a sweep, 2 a batch)")
    if launches["edge_relax"] != st.batches * 2:
        raise AssertionError(f"edge_relax launched {launches['edge_relax']}"
                             f" times, expected {st.batches} x 2")
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
        profile_device(torch, lambda: eng.ssd(batch), 8,
                       f"SSD batches of {len(batch)}", card)
    return {"launches": launches, "requests": requests, "results": results,
            "stats": st, "engine": eng}


# ------------------------------------------------------------- phase 5
def save_stores(ix, root: str) -> dict:
    """``ix`` saved as one store a codec under ``root``, the saves run
    side by side (numpy's zlib releases the interpreter lock); prints
    each store's bytes on disk and decompressed.  codec -> path."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.storage import segment_bytes, segment_logical_bytes

    def save(codec):
        path = os.path.join(root, codec)
        t0 = time.perf_counter()
        ix.save_store(path, codec=codec)
        return path, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(STORE_CODECS)) as pool:
        saved = dict(zip(STORE_CODECS, pool.map(save, STORE_CODECS)))
    say(f"saved {len(saved)} stores in {time.perf_counter() - t0:.1f} s")
    for codec, (path, secs) in saved.items():
        say(f"store {codec}: segments {segment_bytes(path)} bytes on disk, "
            f"{segment_logical_bytes(path)} decompressed; resident tier "
            f"{os.path.getsize(os.path.join(path, 'resident.npz'))} bytes; "
            f"written in {secs:.1f} s")
    return {codec: path for codec, (path, _) in saved.items()}


def serve_store(np, torch, card: str, path: str, budget: int, depth: int,
                mem: dict, what: str, dev: str = "cuda",
                shards: int = None) -> dict:
    """Phase 4's request stream through a store-backed server on the
    card; every answer, cache hit and padded slot must equal phase 4's,
    ``edge_relax`` launch once a streamed level and the device meter
    the cache's bytes.  Returns the run's numbers, and its open
    ``server``."""
    from repro_torch.kernels.edge_relax import relax_sweep_
    from repro_torch.kernels.tropical_matmul import minplus
    from repro_torch.launch.serve import QueryServer

    server = QueryServer(store_path=path, cache_bytes=budget,
                         batch_size=BATCH, queue_depth=depth, shards=shards,
                         engine_opts={"device": dev}, warm_start=True)
    eng, store = server.engine, server.store
    eng.times.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    relax_sweep_.launches = 0
    minplus.launches = 0
    t0 = time.perf_counter()
    results = server.serve_stream(mem["requests"])
    wall = time.perf_counter() - t0
    launches = {"edge_relax": relax_sweep_.launches,
                "tropical_matmul": minplus.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    st, cs, io = server.stats, store.cache.stats, store.device.stats
    levels = store.n_real("plan_f") + store.n_real("plan_b")
    for a, b in zip(mem["results"], results):
        if (a.source, a.cached) != (b.source, b.cached):
            raise AssertionError(f"{what}: request {a.source} served "
                                 "otherwise than in memory")
        np.testing.assert_array_equal(b.dist, a.dist)
    ms = mem["stats"]
    if (st.requests, st.cache_hits, st.padded_slots, st.batches) != (
            ms.requests, ms.cache_hits, ms.padded_slots, ms.batches):
        raise AssertionError(f"{what}: served {st}, in memory {ms}")
    if launches["edge_relax"] != st.batches * levels:
        raise AssertionError(f"{what}: edge_relax launched "
                             f"{launches['edge_relax']} times, expected "
                             f"{st.batches} batches x {levels} levels")
    if launches["tropical_matmul"] < st.batches:
        raise AssertionError(f"{what}: tropical_matmul launched fewer "
                             "times than there were batches")
    metered = io.bytes_seq + io.bytes_rand
    if not metered == cs.bytes_read == st.store_bytes_read:
        raise AssertionError(f"{what}: the device metered {metered} bytes, "
                             f"the cache read {cs.bytes_read}, the server "
                             f"{st.store_bytes_read}")
    lat = np.array([r.latency_s for r in results]) * 1e3
    t = eng.times
    run = {"qps": st.requests / wall, "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)),
           "hit_rate": st.page_hit_rate(), "bytes_read": cs.bytes_read,
           "bytes_filled": cs.bytes_filled, "peak_gb": peak_gb,
           "launches": launches, "server": server, "results": results,
           "counters": (cs.hits, cs.misses, cs.evictions, cs.bytes_read,
                        cs.bytes_filled),
           "io": (io.seq_blocks, io.rand_blocks, io.bytes_seq,
                  io.bytes_rand)}
    say(f"{what}: {run['qps']:.1f} q/s over {wall:.3f} s, latency p50 "
        f"{run['p50_ms']:.3f} ms p99 {run['p99_ms']:.3f} ms; page cache "
        f"hit rate {run['hit_rate']:.4f} ({cs.hits} hits, {cs.misses} "
        f"misses), {cs.bytes_read} bytes read, {cs.bytes_filled} filled; "
        f"peak device memory {peak_gb:.3f} GB; launches {launches}; "
        f"stall (modeled) {st.stall_seconds * 1e3:.1f} ms, measured wait "
        f"{st.stall_wall_seconds * 1e3:.1f} ms; on {card}")
    n = max(t.levels, 1)
    say(f"  host time a streamed level ({t.levels} levels): read "
        f"{t.read_s / n * 1e6:.1f} us (the reap wait "
        f"{st.stall_wall_seconds / n * 1e6:.1f} us of it), pack "
        f"{t.pack_s / n * 1e6:.1f} us, upload {t.upload_s / n * 1e6:.1f} us "
        f"(buffer wait {eng._stager.wait_s / n * 1e6:.1f} us), launch "
        f"{t.launch_s / n * 1e6:.1f} us; largest copy "
        f"{eng._stager.peak_bytes} bytes; pinned host buffers "
        f"{sum(b is not None and b.is_pinned() for b in eng._stager._bufs)}"
        f" of 2; on {card}")
    return run


def check_store_modes(np, torch, card: str, eng, mem_eng, batch) -> None:
    """One batch of each other query of the streaming engine against
    the in-memory engine on the card."""
    rng = np.random.default_rng(1)
    targets = rng.integers(0, mem_eng.index.n, len(batch)).astype(np.int32)
    d, p = eng.sssp(batch)
    dm, pm = mem_eng.sssp(batch)
    np.testing.assert_array_equal(d, dm)
    np.testing.assert_array_equal(p, pm)
    want = mem_eng.p2p(batch, targets)
    for early_term in (True, False):
        np.testing.assert_array_equal(
            eng.p2p(batch, targets, early_term=early_term), want)
    np.testing.assert_array_equal(eng.ssd_within(batch, 60.0),
                                  mem_eng.ssd_within(batch, 60.0))
    for a, b in zip(eng.knn(batch, 10), mem_eng.knn(batch, 10)):
        np.testing.assert_array_equal(a, b)
    full = mem_eng.ssd(batch)
    got, done = eng.ssd_bounded(batch, float("inf"))
    if not done:
        raise AssertionError("ssd_bounded pruned at an infinite bound")
    np.testing.assert_array_equal(got, full)
    farness = np.where(np.isfinite(full), full, 0.0).sum(axis=1,
                                                        dtype=np.float64)
    bound_at = float(np.median(farness))
    got, done = eng.ssd_bounded(batch, bound_at)
    if done:
        np.testing.assert_array_equal(got, full)
    elif not np.all(farness > bound_at):
        raise AssertionError("ssd_bounded pruned a batch within its bound")
    say(f"store engine: sssp (dist, pred), p2p (early stop on and off), "
        f"ssd_within, knn and ssd_bounded ({'completed' if done else 'pruned'}"
        f" at the median farness) equal the in-memory engine on "
        f"{len(batch)} sources, on {card}")


def drive_store(np, torch, card: str, ix, mem: dict, root: str,
                dev: str = "cuda") -> tuple:
    """Phase 5: phase 4's index served from its block store, saved under
    ``root`` (left for phases 8 and 9; the caller removes it).  Returns
    the launches of the raw store's run at 25%, the stores' paths, and
    the cache counters and I/O of the runs at 25% and depth 4 by codec
    (phase 9 holds its 1-shard fleets to them)."""
    from repro_torch.storage import segment_logical_bytes
    paths = save_stores(ix, root)
    logical = segment_logical_bytes(paths["raw"])
    runs = {}
    for codec, frac, depth in STORE_RUNS:
        what = f"store {codec} at {frac:.0%}, queue depth {depth}"
        runs[codec, frac, depth] = run = serve_store(
            np, torch, card, paths[codec], int(frac * logical), depth,
            mem, what, dev)
        if (codec, frac, depth) != ("raw", 0.25, 4):
            run.pop("server").close()
        free(torch)
    raw5, raw25 = runs["raw", 0.05, 4], runs["raw", 0.25, 4]
    if not raw5["hit_rate"] < 1.0 or not raw25["hit_rate"] > 0.0:
        raise AssertionError(f"hit rates {raw5['hit_rate']} at 5%, "
                             f"{raw25['hit_rate']} at 25%")
    if not runs["delta", 0.25, 4]["bytes_read"] < raw25["bytes_read"]:
        raise AssertionError("the delta store read no fewer bytes than "
                             "the raw one")
    sync = runs["raw", 0.25, 1]
    if (sync["counters"], sync["io"]) != (raw25["counters"],
                                          raw25["io"]):
        raise AssertionError(f"queue depth 1 read {sync['counters']} "
                             f"{sync['io']}, depth 4 {raw25['counters']}"
                             f" {raw25['io']}")
    for a, b in zip(sync["results"], raw25["results"]):
        np.testing.assert_array_equal(a.dist, b.dist)
    say("queue depth 1 equals depth 4: answers, cache counters, I/O")

    eng = raw25["server"].engine
    batch = np.unique(mem["requests"])[:BATCH].astype(np.int32)
    check_store_modes(np, torch, card, eng, mem["engine"], batch)
    if dev == "cuda":
        split = profile_device(torch, lambda: eng.ssd(batch), 4,
                               f"streamed SSD batches of {len(batch)} "
                               "(raw store at 25%)", card)
        copies = sum(us for key, us in
                     split.get("device_us", {}).items() if "HtoD" in key)
        say(f"  H2D slab copies {copies:.1f} us/call of "
            f"{split.get('busy_us', 0.0):.1f} us busy, idle share "
            f"{split.get('idle_share', float('nan')):.3f}")
    raw25.pop("server").close()
    unsharded = {codec: (run["counters"], run["io"])
                 for (codec, frac, depth), run in runs.items()
                 if (frac, depth) == (FLEET_FRAC, FLEET_DEPTH)}
    return raw25["launches"], paths, unsharded


# ------------------------------------------------------------- phase 8
def launch_counts(reset: bool = False) -> dict:
    """The HoD kernels' launch counters (zeroed first with ``reset``)."""
    from repro_torch.kernels.edge_relax import relax_sweep_
    from repro_torch.kernels.tropical_matmul import minplus
    if reset:
        relax_sweep_.launches = 0
        minplus.launches = 0
    return {"edge_relax": relax_sweep_.launches,
            "tropical_matmul": minplus.launches}


def mixed_oracle(np, eng, stream) -> dict:
    """Phase 4's engine's answer to every distinct request of a mixed
    stream: an ``ssd`` row per source, a ``p2p`` scalar per pair."""
    srcs = sorted({a[0] for m, a in stream if m == "ssd"})
    pairs = sorted({a for m, a in stream if m == "p2p"})
    want = {}
    for lo in range(0, len(srcs), BATCH):
        chunk = np.asarray(srcs[lo:lo + BATCH], np.int32)
        for s_, row in zip(chunk.tolist(), eng.ssd(chunk)):
            want["ssd", (s_,)] = row
    if pairs:
        pa = np.asarray(pairs, np.int32)
        for pair, d in zip(pairs, eng.p2p(pa[:, 0], pa[:, 1])):
            want["p2p", pair] = np.float32(d)
    return want


def serve_mixed(np, torch, card: str, server, stream, rate: float,
                want: dict, what: str, dev: str) -> dict:
    """``stream`` through ``server``'s async path at Poisson ``rate``
    (``_open_loop``, the serve CLI's load generator); every future must
    resolve to phase 4's answer, and the SLO report must hold the ssd,
    p2p and cached p2p classes.  Prints each class's p50/p99 and misses.
    Returns the run's launches, q/s and rows."""
    import asyncio

    from repro_torch.launch.serve import _open_loop
    server.warmup()
    if server.store is not None:
        server.engine.times.reset()
    launch_counts(reset=True)
    t0 = time.perf_counter()
    results = asyncio.run(_open_loop(server, stream, rate))
    wall = time.perf_counter() - t0
    launches = launch_counts()
    if len(results) != len(stream):
        raise AssertionError(f"{what}: {len(results)} of {len(stream)} "
                             "requests answered")
    for (mode, args), r in zip(stream, results):
        if (r.mode, (r.source,) if r.target is None
                else (r.source, r.target)) != (mode, args):
            raise AssertionError(f"{what}: request {mode}{args} answered "
                                 f"as {r.mode} {r.source} {r.target}")
        np.testing.assert_array_equal(r.dist, want[mode, args])
    rows = {r["cls"]: r for r in server.slo_report()}
    if not {"ssd", "p2p", "p2p.cached"} <= set(rows):
        raise AssertionError(f"{what}: slo_report rows {sorted(rows)}")
    if dev == "cuda" and not (launches["edge_relax"] > 0
                              and launches["tropical_matmul"] > 0):
        raise AssertionError(f"{what}: kernel launches {launches}")
    st = server.stats
    say(f"{what}: {len(stream)} requests in {wall:.3f} s at "
        f"{rate:g} req/s offered = {len(stream) / wall:.1f} q/s; "
        f"{st.batches} batches, {st.cache_hits} row-cache hits, "
        f"{st.padded_slots} padded slots, {st.deadline_misses} deadline "
        f"misses; engine busy {st.busy_seconds:.3f} s "
        f"({st.throughput():.1f} q/s busy basis); launches {launches}; "
        f"on {card}")
    for cls, r in rows.items():
        missed = (f", {r['deadline_misses']} past {r['deadline_ms']:g} ms"
                  if r["deadline_ms"] and cls == r["mode"] else "")
        say(f"  class {cls:<11} p50 {r['p50_ms']:9.3f} ms  p99 "
            f"{r['p99_ms']:9.3f} ms  ({r['requests']} answered{missed}); "
            f"on {card}")
    return {"launches": launches, "qps": len(stream) / wall,
            "rows": rows, "stats": st}


def traced_pair(np, torch, card: str, make, requests, what: str,
                store: bool) -> None:
    """The tracer is a pure observer: ``requests`` served closed-loop by
    ``make(tracer, depth)`` with a tracer and without give the same
    answers, ``ServerStats`` counters, ``CacheStats`` and ``IOStats``;
    the trace validates; a store trace holds the whole span taxonomy,
    and its query-thread sequence is the same at queue depths 1 and 4.
    Then the same two servers serve the stream again, row cache cleared
    before each pass (the tracer too): traced and untraced q/s over the
    warm passes, the third on."""
    import dataclasses
    import threading

    from repro_torch.obs import Tracer, validate_chrome_trace
    me = threading.current_thread().name

    def counters(server):
        st = dataclasses.asdict(server.stats)
        for f in ("busy_seconds", "stall_seconds", "stall_wall_seconds",
                  "ttfl_seconds"):
            st.pop(f)
        cs = (dataclasses.astuple(server.store.cache.stats) if store
              else None)
        return st, cs, dataclasses.astuple(server.modeled_io())

    tr = Tracer()
    servers = {True: make(tr, 4), False: make(None, 4)}
    qps = {True: [], False: []}
    try:
        first = {}
        for traced_on, server in servers.items():
            t0 = time.perf_counter()
            res = server.serve_stream(requests)
            qps[traced_on].append(len(requests) / (time.perf_counter() - t0))
            first[traced_on] = (res, counters(server))
        for a, b in zip(first[True][0], first[False][0]):
            if (a.source, a.cached) != (b.source, b.cached):
                raise AssertionError(f"{what}: traced request {a.source} "
                                     "served otherwise")
            np.testing.assert_array_equal(a.dist, b.dist)
        if first[True][1] != first[False][1]:
            raise AssertionError(f"{what}: traced counters "
                                 f"{first[True][1]} differ from untraced "
                                 f"{first[False][1]}")
        problems = validate_chrome_trace(tr.chrome())
        if problems:
            raise AssertionError(f"{what}: invalid Chrome trace "
                                 f"{problems[:5]}")
        names = {e["name"] for e in tr.events()}
        need = {"query.ssd", "jit.dispatch"}
        if store:
            need |= {"pipe.submit", "level.read", "level.decode",
                     "level.wait", "level.relax", "core.search",
                     "cache.hit", "cache.miss", "device.read"}
            tr1 = Tracer()
            server = make(tr1, 1)
            try:
                server.serve_stream(requests)
            finally:
                server.close()
            if tr1.sequence(me) != tr.sequence(me):
                raise AssertionError(f"{what}: the query thread's span "
                                     "sequence differs between depths 1 "
                                     "and 4")
        if not need <= names:
            raise AssertionError(f"{what}: trace lacks "
                                 f"{sorted(need - names)}")
        say(f"{what}: traced run equals untraced (answers, ServerStats, "
            f"{'CacheStats, ' if store else ''}IOStats); "
            f"{len(tr.events())} events, valid Chrome trace"
            + ("; query-thread sequence equal at depths 1 and 4" if store
               else ""))
        for _ in range(OVERHEAD_PASSES - 1):
            for traced_on, server in servers.items():
                server._cache.clear()
                tr.clear()
                t0 = time.perf_counter()
                server.serve_stream(requests)
                qps[traced_on].append(len(requests)
                                      / (time.perf_counter() - t0))
    finally:
        for server in servers.values():
            server.close()
    warm = {k: float(np.median(v[2:])) for k, v in qps.items()}
    say(f"  {what}, passes 3-{OVERHEAD_PASSES} (median, the row cache "
        f"cleared before each): untraced {warm[False]:.1f} q/s, traced "
        f"{warm[True]:.1f} q/s ({warm[True] / warm[False] - 1:+.1%}); "
        f"every pass untraced {[round(x, 1) for x in qps[False]]}, traced "
        f"{[round(x, 1) for x in qps[True]]}; on {card}")


def drive_mixed(np, torch, card: str, g, mem: dict, raw_path: str,
                dev: str = "cuda") -> dict:
    """Phase 8: the serving front end at full width — the mixed ssd:p2p
    config under both schedulers in memory and under ``slo`` from the
    raw store at 25%, the tracer as a pure observer, and the paper's
    closeness application.  Returns the launches of each new path."""
    from repro_torch.config import SERVE_DEFAULTS, Config
    from repro_torch.core import estimate_closeness, topk_closeness
    from repro_torch.launch.serve import (QueryServer, mixed_request_stream,
                                          server_from_config)
    from repro_torch.storage import segment_logical_bytes
    eng = mem["engine"]
    budget = int(0.25 * segment_logical_bytes(raw_path))
    path = str(ROOT / MIXED_CONFIG)
    base = Config(path, defaults=SERVE_DEFAULTS)
    n_req, rate = int(base.get("serve.requests")), float(base.get("serve.rate"))
    stream = mixed_request_stream(base, g.n, n_req, np.random.default_rng(0))
    want = mixed_oracle(np, eng, stream)
    say(f"mixed stream ({MIXED_CONFIG}): {n_req} requests, "
        f"{sum(m == 'p2p' for m, _ in stream)} p2p over "
        f"{sum(k[0] == 'p2p' for k in want)} pairs, "
        f"{sum(m == 'ssd' for m, _ in stream)} ssd; batch "
        f"{base.get('serve.batch')}, max_wait_ms "
        f"{base.get('serve.max_wait_ms')}, slo {base.get('serve.slo')}")
    paths = {}
    runs = {}
    for sched in ("slo", "fifo"):
        cfg = Config(path, defaults=SERVE_DEFAULTS,
                     overrides={"serve": {"scheduler": sched}})
        server = server_from_config(cfg, engine=eng)
        runs[sched] = serve_mixed(np, torch, card, server, stream, rate,
                                  want, f"mixed in memory, {sched}", dev)
        server.close()
    paths["hod_mixed_slo"] = runs["slo"]["launches"]

    cfg = Config(path, defaults=SERVE_DEFAULTS)
    server = server_from_config(cfg, store_path=raw_path,
                                cache_bytes=budget,
                                engine_opts={"device": dev})
    try:
        run = serve_mixed(np, torch, card, server, stream, rate, want,
                          "mixed from the raw store at 25%, slo", dev)
        st = run["stats"]
        say(f"  page cache hit rate {st.page_hit_rate():.4f} "
            f"({st.page_hits} hits, {st.page_misses} misses), "
            f"{st.store_bytes_read} bytes read")
    finally:
        server.close()
    paths["hod_store_mixed_slo"] = run["launches"]
    free(torch)

    requests = mem["requests"]

    def in_memory(tracer, depth):
        return QueryServer(eng, batch_size=BATCH, tracer=tracer,
                           warm_start=True)

    def from_store(tracer, depth):
        return QueryServer(store_path=raw_path, cache_bytes=budget,
                           batch_size=BATCH, queue_depth=depth,
                           tracer=tracer, engine_opts={"device": dev},
                           warm_start=True)

    traced_pair(np, torch, card, in_memory, requests,
                "tracer, in memory", store=False)
    eng.tracer = None
    traced_pair(np, torch, card, from_store, requests,
                "tracer, raw store at 25%", store=True)
    free(torch)

    cand = np.random.default_rng(0).choice(g.n, TOPK_CANDIDATES,
                                           replace=False)
    t0 = time.perf_counter()
    full = topk_closeness(eng, k=TOPK_K, candidates=cand)
    full_s = time.perf_counter() - t0
    server = QueryServer(store_path=raw_path, cache_bytes=budget,
                         batch_size=BATCH, engine_opts={"device": dev},
                         warm_start=True)
    try:
        launch_counts(reset=True)
        t0 = time.perf_counter()
        bounded = topk_closeness(server.engine, k=TOPK_K, candidates=cand)
        bounded_s = time.perf_counter() - t0
        paths["hod_topk_store"] = launch_counts()
        cs = server.store.cache.stats
    finally:
        server.close()
    np.testing.assert_array_equal(bounded.nodes, full.nodes)
    np.testing.assert_array_equal(bounded.farness, full.farness)
    if full.pruned:
        raise AssertionError("full sweeps pruned a candidate")
    say(f"top-{TOPK_K} closeness over {TOPK_CANDIDATES} candidates: in "
        f"memory {full.batches} batches in {full_s:.3f} s; from the raw "
        f"store at 25% (bounded sweeps) {bounded.batches} batches, "
        f"{bounded.pruned} candidates pruned, {bounded_s:.3f} s, "
        f"{cs.bytes_read} bytes read; nodes and farness equal; best "
        f"{bounded.nodes[:3].tolist()} farness "
        f"{bounded.farness[:3].tolist()}; launches "
        f"{paths['hod_topk_store']}; on {card}")
    t0 = time.perf_counter()
    est = estimate_closeness(eng, eps=CLOSENESS_EPS,
                             batch_size=CLOSENESS_BATCH)
    est_s = time.perf_counter() - t0
    if est.closeness.shape != (g.n,) or not np.isfinite(
            est.closeness).all() or not (est.closeness > 0).all():
        raise AssertionError("estimate_closeness: bad closeness vector")
    say(f"estimate_closeness(eps={CLOSENESS_EPS}, batch_size="
        f"{CLOSENESS_BATCH}) in memory: {est.k} sources, {est.batches} "
        f"batches, {est_s:.3f} s (query {est.query_seconds:.3f} s); "
        f"on {card}")
    if dev == "cuda" and not all(
            n["edge_relax"] and n["tropical_matmul"] for n in paths.values()):
        raise AssertionError(f"phase 8 paths without launches: {paths}")
    return paths


# ------------------------------------------------------------- phase 9
def fleet_lines(card: str, fleet_stats) -> None:
    """The fleet's per-shard rows (``FleetStats.report_lines``)."""
    for line in fleet_stats.report_lines():
        say(f"{line}; on {card}")


def serve_fleets(np, torch, card: str, path: str, codec: str, mem: dict,
                 unsharded: tuple, dev: str) -> tuple:
    """Phase 4's stream from one store at each shard count of
    FLEET_SHARDS (phase 5's checks in ``serve_store``), held to phase
    5's unsharded counters at one shard and to the JAX bench's gate
    (more shards never read more bytes) above it.  Returns the
    launches of the runs, summed, and the IOStats of one cold query
    (its page cache emptied first) on the 1-shard fleet's engine."""
    from repro_torch.storage import segment_logical_bytes
    budget = int(FLEET_FRAC * segment_logical_bytes(path))
    launches = {"edge_relax": 0, "tropical_matmul": 0}
    one = None
    for n in FLEET_SHARDS:
        what = (f"fleet {codec} at {FLEET_FRAC:.0%}, {n} shard"
                f"{'s' if n > 1 else ''}, queue depth {FLEET_DEPTH}")
        run = serve_store(np, torch, card, path, budget, FLEET_DEPTH, mem,
                          what, dev, shards=n)
        server = run.pop("server")
        try:
            fs = server.fleet_report()
            if n == 1:
                src = mem["requests"][:1]
                server.store.cache.clear()
                server.store.device.reset()
                got = server.engine.ssd(src)
                cold = (server.store.device.reset(),
                        server.store.block_bytes)
                np.testing.assert_array_equal(got[0], mem["results"][0].dist)
        finally:
            server.close()
        if not server.fleet._workers_down:
            raise AssertionError(f"{what}: shard workers left running")
        fleet_lines(card, fs)
        if len(fs.rows) != n:
            raise AssertionError(f"{what}: {len(fs.rows)} shard rows")
        if sum(r["bytes_read"] for r in fs.rows) != fs.cache.bytes_read:
            raise AssertionError(f"{what}: per-shard bytes read "
                                 f"{[r['bytes_read'] for r in fs.rows]} "
                                 f"do not sum to {fs.cache.bytes_read}")
        if n == 1:
            one = run
            if (run["counters"], run["io"]) != unsharded:
                raise AssertionError(f"{what}: counters {run['counters']} "
                                     f"{run['io']}, unsharded "
                                     f"{unsharded[0]} {unsharded[1]}")
            say(f"  1 shard: CacheStats and IOStats equal phase 5's "
                f"unsharded {codec} run")
        elif run["bytes_read"] > one["bytes_read"]:
            raise AssertionError(f"{what}: read {run['bytes_read']} bytes, "
                                 f"1 shard {one['bytes_read']}")
        if n == 2 and not all(r["hit_rate"] > 0 for r in fs.rows
                              if r["blocks"]):
            raise AssertionError(f"{what}: a shard owning blocks never "
                                 f"hit: {fs.rows}")
        for name in launches:
            launches[name] += run["launches"][name]
        free(torch)
    return launches, cold


def check_baselines(np, torch, card: str, g, mem: dict, hod, block_bytes,
                    dev: str) -> None:
    """The paper's baselines: EM-Dijk against phase 4's answers and its
    modeled I/O a query beside ``hod``, a cold HoD query's IOStats on
    ``block_bytes`` blocks; VC-Index and the reference builder on a
    smaller grid, the reference build served on the card."""
    from repro_torch.core import (BuildConfig, QueryEngine, build_hod,
                                  dijkstra_reference, grid_road_graph,
                                  pack_index, symmetrize)
    from repro_torch.core.baselines import VCIndex, em_dijkstra
    from repro_torch.launch.serve import QueryServer
    by_src = {}
    for r in mem["results"]:
        by_src.setdefault(r.source, r.dist)
    sources = sorted(by_src)[:EM_SOURCES]
    t0 = time.perf_counter()
    em_io = []
    for s_ in sources:
        dist, io = em_dijkstra(g, s_)
        want = by_src[s_]
        if not np.array_equal(np.isfinite(dist), np.isfinite(want)):
            raise AssertionError(f"em_dijkstra {s_}: reachability differs")
        fin = np.isfinite(want)
        np.testing.assert_allclose(dist[fin], want[fin], rtol=EM_RTOL)
        em_io.append(io)
    em_s = (time.perf_counter() - t0) / len(sources)
    say(f"em_dijkstra from {len(sources)} of phase 4's sources on the "
        f"side-{SIDE} graph: within rtol {EM_RTOL} of the card's fp32 "
        f"answers; {em_s * 1e3:.1f} ms a query on the host; on {card}")

    hod_s = hod.modeled_seconds(block_bytes=block_bytes)
    em_rand = sum(io.rand_blocks for io in em_io) / len(em_io)
    em_seq = sum(io.seq_blocks for io in em_io) / len(em_io)
    em_ms = sum(io.modeled_seconds() for io in em_io) / len(em_io) * 1e3
    say(f"modeled I/O a query ({block_bytes >> 10} KiB blocks, "
        f"120 MB/s, 8 ms a seek): "
        f"EM-Dijk {em_rand:.1f} random + {em_seq:.1f} sequential blocks, "
        f"{em_ms:.1f} ms; HoD cold (page cache emptied) from the raw store "
        f"{hod.rand_blocks} "
        f"random + {hod.seq_blocks} sequential blocks, {hod_s * 1e3:.1f} "
        f"ms (core closure resident); on {card}")

    small = grid_road_graph(BASELINE_SIDE, seed=0)
    und = symmetrize(small)
    t0 = time.perf_counter()
    vc = VCIndex(und, top_nodes=VC_TOP_NODES)
    vc_build = time.perf_counter() - t0
    vc_src = [0, und.n // 2, und.n - 1]
    oracle = dijkstra_reference(und, vc_src)
    t0 = time.perf_counter()
    vc_io = []
    for i, s_ in enumerate(vc_src):
        dist, io = vc.ssd(s_)
        np.testing.assert_allclose(dist, oracle[i], rtol=EM_RTOL)
        vc_io.append(io)
    vc_q = (time.perf_counter() - t0) / len(vc_src)
    say(f"VCIndex(top_nodes={VC_TOP_NODES}) on the symmetrized side-"
        f"{BASELINE_SIDE} grid (n={und.n}): {len(vc.levels)} levels, "
        f"{len(vc.top_nodes_ids)} top nodes, built in {vc_build:.2f} s; "
        f"ssd from {len(vc_src)} sources equals host Dijkstra, "
        f"{vc_q * 1e3:.1f} ms a query, modeled I/O "
        f"{vc_io[0].seq_blocks} sequential blocks "
        f"{vc_io[0].modeled_seconds() * 1e3:.2f} ms; on {card}")

    t0 = time.perf_counter()
    res = build_hod(small, BuildConfig(max_core_nodes=512,
                                       max_core_edges=1 << 15))
    build_s = time.perf_counter() - t0
    ix = pack_index(small, res, chunk=2048, k_cap=K_SLOTS, device=dev)
    server = QueryServer(QueryEngine(ix, device=dev), batch_size=BATCH,
                         warm_start=True)
    rng = np.random.default_rng(9)
    reqs = rng.choice(small.n, 2 * BATCH, replace=False).astype(np.int32)
    launch_counts(reset=True)
    results = server.serve_stream(reqs)
    launches = launch_counts()
    want = dijkstra_reference(small, reqs).astype(np.float32)
    for r, w in zip(results, want):
        np.testing.assert_array_equal(r.dist, w)
    if dev == "cuda" and not (launches["edge_relax"]
                              and launches["tropical_matmul"]):
        raise AssertionError(f"build_hod index served without the "
                             f"kernels: {launches}")
    say(f"build_hod on the side-{BASELINE_SIDE} grid (n={small.n}): "
        f"{res.stats.rounds} rounds, core {ix.n_core}, "
        f"{res.stats.shortcuts_added} shortcuts in {build_s:.2f} s on the "
        f"host; {len(reqs)} requests served on the card equal host "
        f"Dijkstra; launches {launches}; on {card}")


def drive_fleet(np, torch, card: str, g, mem: dict, stores: dict,
                unsharded: dict, dev: str = "cuda") -> dict:
    """Phase 9: the fleet over phase 5's raw and delta stores at 1, 2
    and 4 shards, the fleet config under ``slo``, and the paper's
    baselines.  Returns the launches of each fleet path."""
    from repro_torch.config import SERVE_DEFAULTS, Config
    from repro_torch.launch.serve import (mixed_request_stream,
                                          server_from_config)
    from repro_torch.storage import segment_logical_bytes
    paths, cold = {}, {}
    for codec in ("raw", "delta"):
        paths[f"hod_fleet_{codec}"], cold[codec] = serve_fleets(
            np, torch, card, stores[codec], codec, mem, unsharded[codec],
            dev)

    cfg = Config(str(ROOT / FLEET_CONFIG), defaults=SERVE_DEFAULTS)
    codec, shards = cfg.get("store.codec"), cfg.get("serve.shards")
    path = stores[codec]
    budget = int(float(cfg.get("store.cache_frac"))
                 * segment_logical_bytes(path))
    n_req, rate = int(cfg.get("serve.requests")), float(cfg.get("serve.rate"))
    stream = mixed_request_stream(cfg, g.n, n_req, np.random.default_rng(0))
    want = mixed_oracle(np, mem["engine"], stream)
    server = server_from_config(cfg, store_path=path, cache_bytes=budget,
                                engine_opts={"device": dev})
    what = (f"{FLEET_CONFIG} ({codec}, {shards} shards, "
            f"{cfg.get('serve.scheduler')}, {n_req} requests)")
    try:
        if server.fleet is None or server.fleet.n_shards != shards:
            raise AssertionError(f"{what}: not served by a fleet")
        eng = server.engine
        run = serve_mixed(np, torch, card, server, stream, rate, want, what,
                          dev)
        st, t = run["stats"], eng.times
        n = max(t.levels, 1)
        say(f"  page cache hit rate {st.page_hit_rate():.4f} "
            f"({st.page_hits} hits, {st.page_misses} misses), "
            f"{st.store_bytes_read} bytes read; host time a streamed "
            f"level ({t.levels} levels): read {t.read_s / n * 1e6:.1f} us "
            f"(the reap wait {st.stall_wall_seconds / n * 1e6:.1f} us of "
            f"it), pack {t.pack_s / n * 1e6:.1f} us; on {card}")
        fleet_lines(card, server.fleet_report())
    finally:
        server.close()
    paths["hod_fleet_mixed_slo"] = run["launches"]
    free(torch)

    check_baselines(np, torch, card, g, mem, *cold["raw"], dev)
    free(torch)
    if dev == "cuda" and not all(
            n["edge_relax"] and n["tropical_matmul"] for n in paths.values()):
        raise AssertionError(f"phase 9 paths without launches: {paths}")
    return paths


def profile_device(torch, step, reps: int, what: str, card: str) -> dict:
    """Where the time of ``step`` goes: device time by kernel, and the
    share of the wall time the device sits idle (torch.profiler).
    Returns them a call: ``wall_us``, ``busy_us``, ``idle_share`` and
    ``device_us`` by event name (empty if the profiler saw no device
    time)."""
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
    rows = []      # device-side events only: kernels and copies
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0 and e.device_type != DeviceType.CPU:
            rows.append((us, e.count, e.key))
    busy_us = sum(us for us, _, _ in rows)
    if not rows:
        say("profile: the profiler saw no device time (not measured)")
        return {}
    say(f"profile of {reps} {what}: wall "
        f"{wall_us / reps / 1e3:.3f} ms/call, device busy "
        f"{busy_us / reps / 1e3:.3f} ms/call, device idle share "
        f"{1 - busy_us / wall_us:.3f} (host clock under the profiler, "
        f"on {card})")
    for us, count, key in sorted(rows, reverse=True)[:10]:
        say(f"  {us / reps:10.1f} us/call {us / busy_us:6.1%} of busy  "
            f"{count // reps:5d} calls/call  {key[:80]}")
    return {"wall_us": wall_us / reps, "busy_us": busy_us / reps,
            "idle_share": 1 - busy_us / wall_us,
            "device_us": {key: us / reps for us, _, key in rows}}


# ------------------------------------------- phase 3, the models' kernels
def check_flash_decode(torch, card: str) -> dict:
    """flash_decode at glm4's per-layer decode_32k shape (bf16 caches),
    at three kv_lens, and at one odd shape; timed at the main path's
    kv_len, beside SDPA (GQA) on the same inputs."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref
    gen = torch.Generator(device="cuda").manual_seed(11)
    bf16 = torch.bfloat16
    q = torch.randn((FD_B, FD_H, FD_DH), generator=gen, device="cuda",
                    dtype=bf16)
    k = torch.randn((FD_B, FD_S, FD_KH, FD_DH), generator=gen, device="cuda",
                    dtype=bf16)
    v = torch.randn((FD_B, FD_S, FD_KH, FD_DH), generator=gen, device="cuda",
                    dtype=bf16)
    kv_main = DECODE_CUR + 1
    err = 0.0
    for kv_len in (FD_S, 20001, kv_main):
        got = flash_decode(q, k, v, kv_len)
        e = (got - flash_decode_ref(q, k, v, kv_len)).abs().max().item()
        say(f"flash_decode q {list(q.shape)} caches {list(k.shape)} bf16, "
            f"kv_len {kv_len}: max |kernel - plain| {e:.3e} (atol 1e-4)")
        if not e <= 1e-4:
            raise AssertionError(f"flash_decode kv_len={kv_len}: max error "
                                 f"{e} > 1e-4")
        err = max(err, e)
    # the ring's edges at full width: f32 q (three q terms), kv_len 1,
    # a kv_len that ends mid-tile and mid-ring, and forced split counts
    # whose last split is short (512 tiles in 3 or 5 splits)
    from repro_torch.kernels.flash_decode import ops as fd_ops
    edges = ((q.float(), kv_main, None), (q, 1, None),
             (q.float(), 1, None), (q, 64 * 300 + 17, None),
             (q, kv_main, 3), (q.float(), kv_main, 5))
    for qe, kv_len, n_split in edges:
        got = (flash_decode(qe, k, v, kv_len) if n_split is None
               else fd_ops._launch(qe, k, v, kv_len, n_split=n_split))
        e = (got - flash_decode_ref(qe, k, v, kv_len)).abs().max().item()
        if not e <= 1e-4:
            raise AssertionError(f"flash_decode {qe.dtype} q kv_len={kv_len} "
                                 f"n_split={n_split}: max error {e} > 1e-4")
        err = max(err, e)
    say("flash_decode edge cases at full width (f32 and bf16 q; kv_len 1, "
        "19217 mid-tile, 32761 in 3 and 5 splits): within atol 1e-4")
    # odd shapes: S not a tile multiple, kv_len 1; f32 caches take the
    # SIMT form, bf16 ones the tensor-core form, at dh 16 and 32 too with
    # one and two KV heads a block (TMA boxes of 16, 32 and 64 columns)
    for dt, (bo, ho, kho, dho) in (
            (torch.float32, (3, 9, 3, 64)), (bf16, (3, 9, 3, 64)),
            (bf16, (3, 9, 3, 16)), (bf16, (2, 8, 2, 16)),
            (bf16, (3, 9, 3, 32)), (bf16, (2, 32, 2, 32))):
        qo = torch.randn((bo, ho, dho), generator=gen, device="cuda",
                         dtype=dt)
        ko = torch.randn((bo, 1001, kho, dho), generator=gen, device="cuda",
                         dtype=dt)
        vo = torch.randn((bo, 1001, kho, dho), generator=gen, device="cuda",
                         dtype=dt)
        for kv_len in (1, 1000):
            e = (flash_decode(qo, ko, vo, kv_len)
                 - flash_decode_ref(qo, ko, vo, kv_len)).abs().max().item()
            if not e <= 1e-4:
                raise AssertionError(
                    f"flash_decode odd shape q {list(qo.shape)} caches "
                    f"{list(ko.shape)} {dt} kv_len={kv_len}: max error {e} "
                    f"> 1e-4")
    say("flash_decode odd shapes (S 1001; f32 caches at dh 64, bf16 at dh "
        "16, 32, 64 with Kh 2 and 3), kv_len 1 and 1000: within atol 1e-4")

    row = {"shape": f"q [{FD_B},{FD_H},{FD_DH}] bf16, caches "
                    f"[{FD_B},{FD_S},{FD_KH},{FD_DH}] bf16, kv_len {kv_main}",
           "max_abs_err": err}
    sms, per_sm, smem, stages, _, heads = fd_ops.device_config(q, k)
    n_split, split_len = fd_ops.plan_splits(FD_B, FD_KH // heads, kv_main,
                                            sms, per_sm)
    row["plan"] = (f"{n_split} splits of {split_len}, {heads} KV heads a "
                   f"block, {FD_B * FD_KH // heads * n_split} blocks on "
                   f"{sms} x {per_sm}, {stages} stages, {smem} B shared a "
                   f"block")
    row["ms"] = time_ms(torch, lambda: flash_decode(q, k, v, kv_main),
                        iters=20)
    profile_device(torch, lambda: flash_decode(q, k, v, kv_main), 10,
                   "flash_decode calls at decode_32k's layer", card)
    row["plain_ms"] = time_ms(torch, lambda: flash_decode_ref(
        q, k, v, kv_main), iters=3)
    qs = q.view(FD_B, FD_H, 1, FD_DH)
    ks = k[:, :kv_main].transpose(1, 2)
    vs = v[:, :kv_main].transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qs, ks, vs, enable_gqa=True)
    row["library_ms"] = time_ms(torch, sdpa, iters=20)
    lib_err = (sdpa().reshape(FD_B, FD_H, FD_DH).float()
               - flash_decode_ref(q, k, v, kv_main)).abs().max().item()
    # Bytes: K and V rows below kv_len once, q in, f32 out; operations:
    # a multiply-add per (head, position, column) for QK and for PV, bf16
    # products on the tensor cores.
    row["bound_ms"], row["bound_by"] = bound(
        2.0 * FD_B * FD_KH * kv_main * FD_DH * 2 + FD_B * FD_H * FD_DH * 6,
        4.0 * FD_B * FD_H * kv_main * FD_DH, BF16_TC_OPS_PER_S)
    say(f"flash_decode: kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, SDPA (library, enable_gqa) "
        f"{row['library_ms']:.4f} ms (its max |SDPA - plain| {lib_err:.3e}), "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
        f"{row['plan']}, on {card}")
    return row


def check_bag_sum(torch, card: str) -> dict:
    """bag_sum at serve_bulk's lookups (rm2's stacked [26e6, 64] f32 table,
    one id a bag, mask ones) bit-equal to the plain version, and a
    multi-hot [65536, 8] case at mask density 0.7; timed at serve_bulk
    beside F.embedding_bag(mode="sum", per_sample_weights=mask)."""
    import torch.nn.functional as F
    from repro_torch.kernels.embedding_bag import bag_sum, bag_sum_ref, take_fill
    gen = torch.Generator(device="cuda").manual_seed(12)
    table = torch.empty((RM2_ROWS, RM2_DIM), device="cuda")
    table.uniform_(-1e-3, 1e-3, generator=gen)
    ids = torch.randint(0, RM2_ROWS, (BULK_BAGS, 1), generator=gen,
                        device="cuda", dtype=torch.int32)
    ones = torch.ones((BULK_BAGS, 1), device="cuda")
    plain = lambda i, m: bag_sum_ref(take_fill(table, i), m)  # noqa: E731
    got = bag_sum(table, ids, ones)
    if not torch.equal(got, plain(ids, ones)):
        raise AssertionError("bag_sum at serve_bulk differs from the plain "
                             "version")
    mids = torch.randint(0, RM2_ROWS, (65536, 8), generator=gen,
                         device="cuda", dtype=torch.int32)
    mmask = (torch.rand((65536, 8), generator=gen, device="cuda")
             < 0.7).float()
    mgot, mwant = bag_sum(table, mids, mmask), plain(mids, mmask)
    rel = ((mgot - mwant).abs() / mwant.abs().clamp_min(1e-30)).max().item()
    if not torch.allclose(mgot, mwant, rtol=1e-6, atol=0):
        raise AssertionError(f"bag_sum multi-hot: max relative error {rel}")
    say(f"bag_sum table [{RM2_ROWS},{RM2_DIM}] f32: ids [{BULK_BAGS},1] "
        f"equal to plain; multi-hot [65536,8] density 0.7 max relative "
        f"error {rel:.3e} (rtol 1e-6)")
    row = {"shape": f"table [{RM2_ROWS},{RM2_DIM}] f32, ids "
                    f"[{BULK_BAGS},1]", "max_abs_err": 0.0}
    row["ms"] = time_ms(torch, lambda: bag_sum(table, ids, ones), iters=20)
    row["plain_ms"] = time_ms(torch, lambda: plain(ids, ones), iters=3)
    row["library_ms"] = time_ms(torch, lambda: F.embedding_bag(
        ids, table, mode="sum", per_sample_weights=ones), iters=20)
    # Bytes: each distinct row gathered once, ids and mask in, rows out.
    rows = int(torch.unique(ids).numel())
    row["bound_ms"], row["bound_by"] = bound(
        4.0 * RM2_DIM * (rows + BULK_BAGS) + 8.0 * BULK_BAGS,
        2.0 * BULK_BAGS * RM2_DIM)
    say(f"bag_sum: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} "
        f"ms, F.embedding_bag (library) {row['library_ms']:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}, {rows} distinct rows) "
        f"on {card}")
    return row


def free(torch) -> None:
    """Return the finished path's memory to the card before the next."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# ------------------------------------------------------------- phase 6
def drive_lm(torch, card: str) -> dict:
    """glm4-9b serving at full width through the port's entry points;
    returns flash_decode's launches in each served run (the f32 logic
    check's own count is asserted there and not reported).  Each run is
    its own function, so its tensors are gone when it returns."""
    from repro_torch.launch.steps import build_cell

    lm_f32_logic(torch, card)
    free(torch)
    t0 = time.perf_counter()
    cell = build_cell("glm4-9b", "decode_32k", device="cuda",
                      batch=DECODE_BATCH)
    torch.cuda.synchronize()
    params, caches = cell.args[0], cell.args[1]
    cfg = cell.meta["cfg"]
    w_bytes = sum(a.numel() * a.element_size() for a in (
        params["embed"], params["ln_f"], params["head"],
        *(a for pos in params["layers"] for a in pos.values())))
    kv_bytes = sum(c[n].numel() * c[n].element_size() for c in caches
                   for n in ("k", "v"))
    say(f"glm4-9b: {cfg.n_layers} layers, {cfg.param_count() / 1e9:.3f} B "
        f"params, {w_bytes / 1e9:.2f} GB bf16 weights and a "
        f"{kv_bytes / 1e9:.2f} GB decode_32k cache (batch "
        f"{cell.meta['reduced']['batch']}) made on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(1)
    launches = {"lm_serve": lm_serve_requests(torch, params, cfg, gen, card)}
    free(torch)
    launches["decode_32k"] = lm_decode_32k(torch, cell, gen, w_bytes,
                                           kv_bytes, card)
    return launches


def check_decode_vs_prefill(torch, got, want, rel_bound: float, what: str,
                            atol: float = None) -> float:
    """Decode logits against prefill of the extended sequences: the
    relative L2 error within ``rel_bound`` (and every logit within
    ``atol`` where given), and the greedy tokens equal wherever noise
    cannot flip them.  Returns the relative L2 error."""
    diff = (got - want).abs()
    err = diff.max().item()
    rel = ((got - want).norm() / want.norm()).item()
    top2 = want.topk(2, dim=-1).values
    firm = (top2[:, 0] - top2[:, 1]) > 2 * diff.max(dim=-1).values
    agree = got.argmax(-1) == want.argmax(-1)
    say(f"LM decode vs prefill ({what}): max |diff| {err:.3e}, relative L2 "
        f"{rel:.3e} (bound {rel_bound:.3e}"
        + (f", atol {atol}" if atol is not None else "")
        + f"), greedy tokens agree {int(agree.sum())} of {agree.numel()} "
        f"({int(firm.sum())} beyond the noise)")
    if not torch.isfinite(want).all() or not rel <= rel_bound \
            or (atol is not None and not err <= atol) \
            or not bool(agree[firm].all()):
        raise AssertionError(f"decode logits differ from prefill of the "
                             f"extended sequences ({what})")
    return rel


def lm_f32_logic(torch, card: str) -> None:
    """glm4-9b's full width at 2 layers in f32: 2 greedy decode steps after
    a 4x64 prefill must equal prefill of the extended sequences at atol
    1e-4, so the bf16 run's distance is rounding, not logic."""
    import dataclasses
    from repro_torch.configs import glm4_9b
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(glm4_9b.CONFIG, n_layers=2,
                              compute_dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(2)
    params = tf.init_params(cfg, gen, device="cuda", dtype=torch.float32)
    prompts = torch.randint(0, cfg.vocab, (4, 64), generator=gen,
                            device="cuda", dtype=torch.int32)
    logits, filled = tf.prefill(params, prompts, cfg)
    cache = tf.make_cache(cfg, 4, 80, dtype=torch.float32, device="cuda")
    for full, part in zip(cache, filled):
        full["k"][:, :, :64] = part["k"]
        full["v"][:, :, :64] = part["v"]
    flash_decode.launches = 0
    tokens = [logits.argmax(-1).to(torch.int32)]
    for i in range(2):
        logits, _ = tf.decode_step(params, cache, tokens[-1], 64 + i, cfg)
        tokens.append(logits.argmax(-1).to(torch.int32))
    torch.cuda.synchronize()
    launches = flash_decode.launches
    if launches != 2 * cfg.n_layers:
        raise AssertionError(f"flash_decode launched {launches} times in the "
                             f"f32 run")
    ext = torch.cat([prompts, torch.stack(tokens[:-1], dim=1)], dim=1)
    want, _ = tf.prefill(params, ext, cfg)
    check_decode_vs_prefill(torch, logits, want, 1.0,
                            "f32, full width, 2 layers", atol=LM_F32_ATOL)


def lm_serve_requests(torch, params, cfg, gen, card: str) -> int:
    """Prefill 4 prompts of 512 tokens into a 1024-slot cache, decode 32
    greedy steps, and hold the last step's logits against a prefill of
    the extended sequences."""
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.models import transformer as tf
    prompts = torch.randint(0, cfg.vocab, (LM_PROMPTS, LM_PROMPT_LEN),
                            generator=gen, device="cuda", dtype=torch.int32)
    flash_decode.launches = 0
    t0 = time.perf_counter()
    logits, filled = tf.prefill(params, prompts, cfg)
    cache = tf.make_cache(cfg, LM_PROMPTS, LM_SERVE_CACHE, device="cuda")
    for full, part in zip(cache, filled):
        full["k"][:, :, :LM_PROMPT_LEN] = part["k"]
        full["v"][:, :, :LM_PROMPT_LEN] = part["v"]
    del filled, full, part
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tokens = [logits.argmax(-1).to(torch.int32)]
    for i in range(LM_SERVE_STEPS):
        logits, _ = tf.decode_step(params, cache, tokens[-1],
                                   LM_PROMPT_LEN + i, cfg)
        tokens.append(logits.argmax(-1).to(torch.int32))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = flash_decode.launches
    if launches != cfg.n_layers * LM_SERVE_STEPS:
        raise AssertionError(f"flash_decode launched {launches} times in "
                             f"{LM_SERVE_STEPS} steps of {cfg.n_layers} "
                             f"layers")
    if not torch.isfinite(logits).all():
        raise AssertionError("decode logits are not finite")
    ext = torch.cat([prompts, torch.stack(tokens[:-1], dim=1)], dim=1)
    want, _ = tf.prefill(params, ext, cfg)
    say(f"LM serve: prefill {LM_PROMPTS}x{LM_PROMPT_LEN} in "
        f"{(t1 - t0) * 1e3:.1f} ms, {LM_SERVE_STEPS} greedy decode steps "
        f"({LM_PROMPTS} requests, cache {LM_SERVE_CACHE}) in "
        f"{(t2 - t1) * 1e3:.1f} ms = "
        f"{LM_PROMPTS * LM_SERVE_STEPS / (t2 - t1):.1f} tokens/s (host "
        f"clock, on {card}); flash_decode launches {launches}")
    check_decode_vs_prefill(torch, logits, want, LM_REL_L2,
                            f"bf16, {cfg.n_layers} layers, last of "
                            f"{LM_SERVE_STEPS} steps")
    lm_check_controls(torch, params, cfg, cache, tokens[-2], want)
    return launches


def _p_bf16_decode(torch, q, k_cache, v_cache, kv_len: int):
    """flash_decode_ref with the Pallas body's rounding of p to the cache
    dtype before the PV product (kernel.py:50), in one block."""
    from repro_torch.kernels.flash_decode import q_scale
    b, h, dh = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, kh, h // kh, dh) * q_scale(dh, q.dtype)
    sc = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float())
    sc = sc.masked_fill(torch.arange(s, device=q.device) >= kv_len,
                        float("-inf"))
    p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    pv = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                      v_cache.float())
    return (pv / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)).reshape(
        b, h, dh)


def lm_check_controls(torch, params, cfg, cache, token, want) -> None:
    """The decode-vs-prefill check's controls: re-run the last decode
    step from the same cache, once sound (which must agree with the
    served step) and once with each planted fault, and hold each reading
    against LM_REL_L2.  The three decode-logic faults must land outside
    it.  The fourth, p rounded to bf16 before PV, is the Pallas body's
    own rounding, which the kernel deliberately leaves out: its reading
    is printed, not asserted (rounding p is noise of the same order as
    the bf16 path's own)."""
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf
    last = LM_PROMPT_LEN + LM_SERVE_STEPS - 1     # the last step's slot

    def stale(q, k, v, n):                        # the new K/V never lands
        k, v = k.clone(), v.clone()
        k[:, n - 1] = 0
        v[:, n - 1] = 0
        return flash_decode(q, k, v, n)

    def rerun(cur_len, attend=None):
        for c in cache:                           # slots the step wrote
            c["k"][:, :, last:] = 0
            c["v"][:, :, last:] = 0
        layers.flash_decode = attend or flash_decode
        try:
            got, _ = tf.decode_step(params, cache, token, cur_len, cfg)
        finally:
            layers.flash_decode = flash_decode
        return ((got - want).norm() / want.norm()).item()

    sound = rerun(last)
    faults = {
        "position off by one (RoPE and slot at cur_len + 1)": rerun(last + 1),
        "self-token dropped (kv_len = cur_len)": rerun(
            last, lambda q, k, v, n: flash_decode(q, k, v, n - 1)),
        "new K/V lost (slot cur_len stale)": rerun(last, stale),
    }
    p_bf16 = rerun(last, lambda q, k, v, n: _p_bf16_decode(torch, q, k, v,
                                                           n))
    say(f"LM check controls (last step re-run, relative L2 against prefill, "
        f"bound {LM_REL_L2:.3e}): sound {sound:.3e}; "
        + "; ".join(f"{k} {v:.3e}" for k, v in faults.items())
        + f"; p rounded to bf16 before PV {p_bf16:.3e} (not asserted)")
    if not sound <= LM_REL_L2:
        raise AssertionError(f"the re-run sound step reads {sound}")
    for what, rel in faults.items():
        if not rel > LM_REL_L2:
            raise AssertionError(f"planted fault '{what}' reads {rel}, "
                                 f"inside the bound {LM_REL_L2}")


def lm_decode_32k(torch, cell, gen, w_bytes: int, kv_bytes: int,
                  card: str) -> int:
    """decode_32k at batch 32: fill the cache from the generator, time 8
    steps at cur_len 32760, profile one."""
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.models import transformer as tf
    params, caches = cell.args[0], cell.args[1]
    cfg = cell.meta["cfg"]
    t0 = time.perf_counter()
    for c in range(cfg.n_cycles):
        for pos in caches:
            pos["k"][c].normal_(generator=gen)
            pos["v"][c].normal_(generator=gen)
    toks = torch.randint(0, cfg.vocab, (DECODE_BATCH,), generator=gen,
                         device="cuda", dtype=torch.int32)
    logits, _ = tf.decode_step(params, caches, toks, DECODE_CUR - 1, cfg)
    torch.cuda.synchronize()
    say(f"decode_32k: cache filled from the generator and one warm-up step "
        f"in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    flash_decode.launches = 0
    t0 = time.perf_counter()
    for i in range(DECODE_STEPS):
        logits, _ = tf.decode_step(params, caches, toks, DECODE_CUR + i, cfg)
        toks = logits.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_decode.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    if launches != cfg.n_layers * DECODE_STEPS:
        raise AssertionError(f"flash_decode launched {launches} times in "
                             f"{DECODE_STEPS} decode_32k steps")
    if logits.shape != (DECODE_BATCH, cfg.vocab) \
            or not torch.isfinite(logits).all():
        raise AssertionError("decode_32k logits are not finite [B, V]")
    # The step's byte bound: every weight but the embedding table (only B
    # rows of it), and the K/V rows up to cur_len of every layer.
    emb = params["embed"]
    step_bytes = (w_bytes - emb.numel() * emb.element_size()
                  + DECODE_BATCH * cfg.d_model * emb.element_size()
                  + kv_bytes * (DECODE_CUR + 1) / FD_S)
    ms = wall / DECODE_STEPS * 1e3
    say(f"decode_32k: batch {DECODE_BATCH} (cut from 128), cur_len "
        f"{DECODE_CUR}: {ms:.2f} ms/step, "
        f"{DECODE_BATCH * DECODE_STEPS / wall:.1f} tokens/s, model "
        f"{cell.model_flops / (ms / 1e3) / 1e12:.2f} TFLOP/s; byte bound "
        f"{step_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms/step "
        f"({step_bytes / 1e9:.1f} GB); peak device memory {peak:.2f} GB; "
        f"flash_decode launches {launches} (host clock, on {card})")
    profile_device(torch, lambda: tf.decode_step(params, caches, toks,
                                                 DECODE_CUR, cfg),
                   2, f"decode_32k steps (batch {DECODE_BATCH})", card)
    return launches


# ------------------------------------------------------------- phase 7
def drive_dlrm(torch, card: str) -> dict:
    """dlrm-rm2 serving at full size through the port's entry points;
    returns bag_sum's launches in each cell's timed calls."""
    from repro_torch.kernels.embedding_bag import bag_sum
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import dlrm

    launches = {}
    cpu_params = None
    for shape, calls in (("serve_p99", 20), ("serve_bulk", 3),
                         ("retrieval_cand", 5)):
        t0 = time.perf_counter()
        cell = build_cell("dlrm-rm2", shape, device="cuda")
        torch.cuda.synchronize()
        params, cfg = cell.args[0], cell.meta["cfg"]
        build_s = time.perf_counter() - t0
        out = cell.run()                                # warm-up
        torch.cuda.synchronize()
        bag_sum.launches = 0
        t0 = time.perf_counter()
        for _ in range(calls):
            out = cell.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if bag_sum.launches != calls:
            raise AssertionError(f"{shape}: bag_sum launched "
                                 f"{bag_sum.launches} times in {calls} calls")
        launches[shape] = bag_sum.launches
        if cpu_params is None:      # one CPU copy: every cell has the same seed
            cpu_params = {"tables": params["tables"].cpu(),
                          "bot": [[w.cpu(), b.cpu()] for w, b in params["bot"]],
                          "top": [[w.cpu(), b.cpu()] for w, b in params["top"]]}
        args_cpu = [a.cpu() for a in cell.args[1:]]
        if cell.kind == "serve":
            n = min(512, args_cpu[0].shape[0])
            want = dlrm.forward(cpu_params, args_cpu[0][:n], args_cpu[1][:n],
                                cfg)
            got = out[:n].cpu()
            if out.shape != (cell.meta["batch"],) \
                    or not torch.isfinite(out).all() \
                    or not torch.allclose(got, want, rtol=1e-5, atol=1e-6):
                raise AssertionError(f"{shape}: logits differ from the CPU "
                                     f"model: max {(got - want).abs().max()}")
            check = f"logits of {n} rows equal the CPU model's (rtol 1e-5)"
            per_s = cell.meta["batch"] * calls / wall
        else:
            vals, ids = out
            wv, wi = dlrm.retrieval_scores(cpu_params, *args_cpu, cfg)
            if not torch.equal(ids.cpu(), wi) \
                    or not torch.allclose(vals.cpu(), wv, rtol=1e-5, atol=1e-6):
                raise AssertionError("retrieval top-128 differs from the CPU "
                                     "model's")
            check = (f"top-128 of {cell.meta['n_candidates']} candidates "
                     f"equal the CPU model's")
            per_s = calls / wall
        ms = wall / calls * 1e3
        say(f"dlrm-rm2 {shape}: batch {cell.meta['batch']}, {ms:.3f} ms/call, "
            f"{per_s:.0f} queries/s, model "
            f"{cell.model_flops / (ms / 1e3) / 1e12:.3f} TFLOP/s (host clock "
            f"over {calls} calls, on {card}); {check}; bag_sum launches "
            f"{calls}; cell built in {build_s:.2f} s")
        if shape == "serve_bulk":
            profile_device(torch, cell.run, 1, f"{shape} calls", card)
        del cell, params, out
        free(torch)
    return launches


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
    # f32 products in full f32 (the DLRM comparisons), stated not assumed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    say(card)
    say(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    global FP32_INSTR_PER_S, SM_HZ
    FP32_INSTR_PER_S, mhz = fp32_instr_per_s(torch)
    SM_HZ = mhz * 1e6
    say(f"fp32 SIMT instruction rate {FP32_INSTR_PER_S:.4e}/s "
        f"({torch.cuda.get_device_properties(0).multi_processor_count} SMs x "
        f"{FP32_LANES_PER_SM} lanes x {mhz:.0f} MHz, clocks.max.sm)")

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build()
    say(f"built kernels {list(_build.KERNELS)} in "
        f"{time.perf_counter() - t0:.1f} s")
    ptxas = {name: ptxas_report(_build.build_log(name))
             for name in _build.KERNELS}
    for name, funcs in ptxas.items():
        for fn, info in funcs.items():
            say(f"  ptxas {name}: {fn}: {info['registers']} registers, "
                f"{info['smem']} B static smem, spill stores "
                f"{info['spill_stores']} B, loads {info['spill_loads']} B")
    # The redesigned split passes and the sweep kernel must not spill
    # (checked after the run, so that a spilling build still reports its
    # times).
    spills = {}
    for name, key in (("tropical_matmul", "minplus_kernel"),
                      ("flash_decode", "decode_split_tc_kernel"),
                      ("edge_relax", "relax_sweep_kernel")):
        hit = {fn: i for fn, i in ptxas[name].items() if key in fn}
        if not hit or any(i["spill_stores"] or i["spill_loads"]
                          for i in hit.values()):
            spills[key] = hit

    rows = {"tropical_matmul": check_minplus(torch, card, BATCH, CORE, CORE)}
    check_minplus_edges(torch, card)
    g, ix = served_index(torch, card, SIDE, CLOSURE_LIMIT)
    rows["edge_relax"] = check_relax_sweeps(np, torch, card, ix)
    check_relax_synthetic(np, torch, BATCH, 2 * 20000, PLAN_F_ROWS, K_SLOTS)
    check_relax_synthetic(np, torch, 45, 998, 301, 5)
    rows["flash_decode"] = check_flash_decode(torch, card)
    free(torch)
    rows["embedding_bag"] = check_bag_sum(torch, card)
    free(torch)

    mem = drive_slice(np, torch, card, g, ix)
    paths = {name: {"hod_serve_stream": n}
             for name, n in mem["launches"].items()}
    root = tempfile.mkdtemp(prefix="hod_store_")
    try:
        t0 = time.perf_counter()
        launches, stores, unsharded = drive_store(np, torch, card, ix, mem,
                                                  root)
        for name, n in launches.items():
            paths[name]["hod_store_stream"] = n
        say(f"store phase took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        for path, counts in drive_mixed(np, torch, card, g, mem,
                                        stores["raw"]).items():
            for name, n in counts.items():
                paths[name][path] = n
        say(f"front-end phase took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        for path, counts in drive_fleet(np, torch, card, g, mem, stores,
                                        unsharded).items():
            for name, n in counts.items():
                paths[name][path] = n
        say(f"fleet and baselines phase took "
            f"{time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del g, ix, mem
    free(torch)
    t0 = time.perf_counter()
    paths["flash_decode"] = drive_lm(torch, card)
    free(torch)
    say(f"LM phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths["embedding_bag"] = drive_dlrm(torch, card)
    free(torch)
    say(f"DLRM phase took {time.perf_counter() - t0:.1f} s")
    if "jax" in sys.modules or any(m == "repro" or m.startswith("repro.")
                                   for m in sys.modules):
        raise AssertionError("the smoke imported jax or the JAX package")
    if spills:
        raise AssertionError(f"ptxas reports spills or no entry: {spills}")

    kernels = []
    for name in REPLACES:
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": paths[name][MAIN_PATH[name]],
            "main_path": MAIN_PATH[name], "launches_by_path": paths[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
            "shape": r["shape"], "plan": r.get("plan"),
            "parts": r.get("parts")})
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
