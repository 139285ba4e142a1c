#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one GPU
and check them.

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
   and masked rows.  ``flash_decode`` also at phase 12's per-layer
   shapes (FD_FAMILY: the dh-64 tensor-core form at G 2 and 8, dh 128
   at G 8, gemma3's dh 256 in the SIMT form at 32,768 and 524,288
   positions and on a rolling 1,024-slot cache), each within atol 1e-4
   of its plain version, timed beside SDPA and its byte bound;
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
   into a 1024-slot cache and decoded greedily for 32 steps; every
   step's logits must match a prefill of the extended sequences within
   a relative L2 bound (LM_REL_L2), and the 32 steps re-run on the same
   inputs from the same cache with each of three planted faults in
   every step must land outside it (the check's controls, ``lm_controls``);
   (b) decode_32k with its batch cut from 128 to 32 (the 128-row cache
   is 172 GB): 42.9 GB of KV filled from the generator, 8 timed decode
   steps at cur_len 32760, and one ``torch.profiler`` pass over a step.
   ``flash_decode`` must launch 40 times a step in each run;
7. DLRM serving at full size: rm2 with 26 x 10^6-row tables (6.66 GB);
   ``forward`` at serve_p99 (B=512) and serve_bulk (B=262,144), and
   ``retrieval_scores`` over 10^6 candidates, checked against the same
   model on the CPU, and one profile of a serve_bulk call; ``bag_sum``
   must launch once a call;
10. training at full width (budget: 150 s), after phase 7.  (a) dlrm-rm2
   train_batch through the train cell: B = 65,536 on RecsysStream's
   Zipf ids, 26 x 10^6-row f32 tables (params, grads, m and v ~26.6 GB).
   5 steps, each loss finite, ``bag_sum`` and ``bag_sum_backward``
   launching once a step; median step (CUDA events), peak memory, a
   profile.  Then one step's table gradient, from the hand-written
   backward through autograd, is held against ``bag_sum_backward_ref``
   on the same ``grad_out`` (each element within 2.5 x (n - 1) x 2^-24 x
   its row's sum of |terms|, n the row's slots, so bit-equal at n = 1;
   a zero output and the crossing runs left at zero must break that
   bound) and must be bit-equal at a second launch; the backward is
   timed beside its plain version and ``index_add_``, its sort and the
   dense zero fill apart.  (b) glm4-9b: its full width at 2
   layers in f32 on 64 tokens, loss and every gradient on the card
   against the CPU's; then train_4k at full width (d 4096, vocab
   151,552, GQA 32/2, d_ff 13,696) with the depth cut to what fits
   beside 16 bytes a parameter and the batch cut to 1 x 4,096 (both
   printed and in ``meta["reduced"]``), bf16 compute, remat on: a
   warm-up step and 3 counted ones, losses finite, median step, peak
   memory, a profile.  (c) resume: at the smoke configs of both models,
   ``ElasticTrainer`` with a failure injected, restored from the
   manifest alone, must end bit-equal to an uninterrupted run;
11. the GNN family at its published widths, after phase 10.  (a) gcn-cora
   on Cora's shape (also in 3 chunks), gin-tu on a sampled block
   (sentinel-padded edges), schnet and equiformer-v2 (2 layers) on 16
   molecules: loss and every gradient on the card against the CPU
   (phase 10's tolerances); (b) five cells through the train cell, a
   warm-up step and 3 counted ones each, losses finite, every leaf that
   gets a gradient moved: gcn-cora full_graph_sm and ogb_products (61.9
   M edges in 15 checkpointed chunks), gin-tu minibatch_lg (NeighborSampler
   blocks of a Reddit-size host graph built in numpy), schnet and
   equiformer-v2 molecule (128 molecules); median step, model TFLOP/s,
   peak memory, profiles of ogb_products and equiformer-v2; (c)
   ogb_products' chunked forward against one unchunked pass;
12. the rest of the LM family, after phase 11: command-r-35b,
   gemma3-12b, granite-moe-1b-a400m and qwen3-moe-30b-a3b (FAMILY), each
   at its published width.  (1) 2 layers (gemma3: one 6-layer cycle) in
   f32: both of 2 greedy decode steps equal a prefill of the extended
   sequences at atol 1e-4, the MoE archs at a capacity factor of E / k
   with no choice dropped (counted through ``moe_route``), gemma3 after a
   1,024-token prompt, so decode wraps its rolling caches; the steps
   re-run with each planted fault (gemma3 also two faults of the ring)
   must each put a logit outside that atol; (2) full
   depth in bf16 (decode_32k's cell, random weights from a seeded
   generator): phase 6's serve run (4 prompts, 32 greedy steps; gemma3's
   prompt one window, its cache 1,088) held to prefill within the
   arch's relative L2 bound over all 32 steps, its planted faults
   outside it (bounds from ``tools/serve_bound_sweep.py``); (3)
   decode_32k with the batch cut to fit one card (command-r 2, gemma3
   16, granite 32, qwen3 8) and gemma3's long_500k at batch 1 (524,288
   positions on its global layers), KV from the generator, 4 timed
   steps, a profile, ``flash_decode`` launching once a layer a step, the
   MoE drop share per layer at the published capacity factor; (4)
   train_4k through the train cell at ``lm_train_layers``'s depth
   (whole cycles) and batch 1 x 4,096, a warm-up and 2 counted steps,
   losses finite, median step, peak memory, a profile; granite-moe and
   gemma3 also hold loss and gradients on the card to the CPU at (1)'s
   depth (phase 10's tolerances).  Its paths in the kernels line:
   ``<arch>_serve``, ``<arch>_decode_32k``, ``<arch>_train`` and
   ``gemma3-12b_long_500k``.

Each path frees its memory before the next.  Every launch counter is
zeroed just before a served run and read just after it.  It prints one
JSON line with every kernel's numbers (``launches`` is the count of the
run at the kernel's timed shape, ``launches_by_path`` each served run's
own count, phase 8's paths ``hod_mixed_slo``,
``hod_store_mixed_slo`` and ``hod_topk_store``, phase 9's
``hod_fleet_raw`` and ``hod_fleet_delta`` (each the sum over its runs
at 1, 2 and 4 shards) and ``hod_fleet_mixed_slo``, phase 10's
``dlrm_train`` and ``lm_train``, phase 11's ``gnn_train`` and phase
12's paths included;
``bag_sum_backward`` has no TPU kernel and names the JAX lookup's
``jnp.take``), the card's name and power limit, and, last,
``{"ok": true, "device": {...}}``.  Any failure
exits non-zero before those lines; without a card, or outside a
checkout, it exits non-zero at once.
"""
import json
import os
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
# error ||decode - prefill|| / ||prefill|| over all 32 steps' logits
# (tests/test_torch_transformer.py holds 2 layers to 2e-2).  It lies
# near the geometric mean of the largest sound reading (1.946e-2) and
# the smallest reading of the planted faults that lm_controls re-runs
# every time (3.321e-2, the self-token dropped) over 5 seeds of weights
# and prompts (tools/serve_bound_sweep.py; PERF.md §6).
# Greedy tokens must agree wherever the reference's top-two gap exceeds
# twice the largest logit error (noise cannot flip those).  An f32 run of
# the same width at 2 layers checks the decode logic itself at the CPU
# test's f32 tolerance, atol 1e-4.
LM_REL_L2, LM_F32_ATOL = 2.5e-2, 1e-4
# flash_decode's check: the per-layer decode_32k shape
FD_B, FD_H, FD_KH, FD_DH, FD_S = 32, 32, 2, 128, 32768
# ... and phase 12's per-layer shapes (what, B, H, Kh, dh, S, kv_len):
# the dh-64 tensor-core form at G 2 and G 8, dh 128 at G 8, gemma3's dh
# 256 (the SIMT form) on a global layer at 32,768 and 524,288 positions
# and on a local layer's rolling 1,024-slot cache, full and before it
# wraps.
FD_FAMILY = (
    ("granite-moe decode_32k", 32, 16, 8, 64, 32768, 32761),
    ("qwen3-moe decode_32k", 8, 32, 4, 64, 32768, 32761),
    ("command-r decode_32k", 2, 64, 8, 128, 32768, 32761),
    ("gemma3 decode_32k global", 16, 16, 8, 256, 32768, 32761),
    ("gemma3 local, rolling", 16, 16, 8, 256, 1024, 1024),
    ("gemma3 local, before the wrap", 16, 16, 8, 256, 1024, 601),
    ("gemma3 long_500k global", 1, 16, 8, 256, 524288, 524281),
)
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

# Phase 10: training at full width.  dlrm-rm2 train_batch (B = 65,536,
# RecsysStream's Zipf ids) for 5 steps; glm4-9b train_4k at full width,
# its depth cut to what fits beside f32 params, grads and AdamW state
# with LM_TRAIN_RESERVE of activations (a step at 13 layers peaked 9.43
# GB above its state on an H100 80GB), its batch cut to LM_TRAIN_BATCH
# sequences, for 3 steps (after one warm-up step); the f32 logic check at
# 2 layers on LM_LOGIC_SEQ tokens; the resume check at the smoke
# configs: RESUME_STEPS steps, checkpoints every RESUME_EVERY, a failure
# injected before step RESUME_FAIL.  bag_sum_backward against its plain
# version: the same f32 terms summed in another order, so each element
# within BWD_SUM_SLACK x (n - 1) x 2^-24 x the row's sum of |terms|, n the
# row's slot count (bit-equal at n = 1; see bwd_violations).  The f32 logic check on the card against the CPU:
# loss rtol 1e-5, each gradient leaf rtol 1e-4 with atol 1e-5 of its
# largest magnitude (f32 sums in another order, as the CPU parity tests).
DLRM_TRAIN_STEPS, LM_TRAIN_STEPS, LM_TRAIN_BATCH = 5, 3, 1
LM_TRAIN_RESERVE = 12 * 2 ** 30
LM_LOGIC_SEQ = 64
RESUME_STEPS, RESUME_EVERY, RESUME_FAIL = 6, 2, 3
BWD_SUM_SLACK = 2.5
LOGIC_RTOL, LOGIC_ATOL_SCALE = 1e-4, 1e-5

# Phase 11: the GNN family at its published widths.  The five cells train
# one warm-up step and GNN_STEPS counted ones; GNN_PROFILED get a
# profile.  The logic check runs each arch at full width on small graphs
# (Equiformer at GNN_LOGIC_EQ_LAYERS layers, molecules GNN_LOGIC_MOLECULES
# a batch), with the phase 10 tolerances; chunked against unchunked
# ogb_products forward within rtol 1e-5 and atol 1e-5 of the largest
# output (f32 sums in another order).
GNN_CELLS = (("gcn-cora", "full_graph_sm"), ("gcn-cora", "ogb_products"),
             ("gin-tu", "minibatch_lg"), ("schnet", "molecule"),
             ("equiformer-v2", "molecule"))
GNN_PROFILED = (("gcn-cora", "ogb_products"), ("equiformer-v2", "molecule"))
GNN_STEPS, GNN_LOGIC_EQ_LAYERS, GNN_LOGIC_MOLECULES = 3, 2, 16
GNN_CHUNK_RTOL, GNN_CHUNK_ATOL_SCALE = 1e-5, 1e-5

# Phase 12: the rest of the LM family, in the JAX registry's order.  Per
# arch: decode_32k's batch, cut to what fits one card beside the bf16
# weights (the 128-row caches are 206-687 GB); the f32 logic check's
# depth and prompt (gemma3: one 6-layer cycle, one 1,024-token window);
# the bf16 serve check's prompt and cache (gemma3's prompt is a window,
# so decode wraps its rolling caches) and its relative L2 bound, set as
# LM_REL_L2 is, from 5 seeds of tools/serve_bound_sweep.py (PERF.md §6);
# train_4k's activation reserve beside 16 B a parameter.  Decode cells
# time FAMILY_DECODE_STEPS steps, train cells FAMILY_TRAIN_STEPS after a
# warm-up; FAMILY_GRAD_CHECK also hold loss and gradients on the card
# to the CPU (phase 10's tolerances) at the logic check's depth.
FAMILY = {
    "command-r-35b": dict(decode_batch=2, logic_layers=2, logic_prompt=64,
                          prompt=512, cache=1024, rel_l2=2.4e-2,
                          train_reserve=20 * 2 ** 30),
    "gemma3-12b": dict(decode_batch=16, logic_layers=6, logic_prompt=1024,
                       prompt=1024, cache=1088, rel_l2=2.4e-2,
                       train_reserve=28 * 2 ** 30),
    "granite-moe-1b-a400m": dict(decode_batch=32, logic_layers=2,
                                 logic_prompt=64, prompt=512, cache=1024,
                                 rel_l2=2.6e-2, train_reserve=12 * 2 ** 30),
    "qwen3-moe-30b-a3b": dict(decode_batch=8, logic_layers=2,
                              logic_prompt=64, prompt=512, cache=1024,
                              rel_l2=4.5e-2, train_reserve=12 * 2 ** 30),
}
FAMILY_DECODE_STEPS, FAMILY_TRAIN_STEPS = 4, 2
FAMILY_GRAD_CHECK = ("granite-moe-1b-a400m", "gemma3-12b")

# The served run whose launch count the kernels line reports: the one at
# the shape each kernel is timed at.
MAIN_PATH = {"edge_relax": "hod_serve_stream",
             "tropical_matmul": "hod_serve_stream",
             "flash_decode": "decode_32k", "embedding_bag": "serve_bulk",
             "bag_sum_backward": "dlrm_train"}

REPLACES = {
    "edge_relax": "src/repro/kernels/edge_relax/kernel.py:35",
    "tropical_matmul": "src/repro/kernels/tropical_matmul/kernel.py:39",
    "flash_decode": "src/repro/kernels/flash_decode/kernel.py:87",
    "embedding_bag": "src/repro/kernels/embedding_bag/kernel.py:20",
    # no TPU counterpart: the gradient XLA derives from jnp.take in the
    # JAX lookup
    "bag_sum_backward": "src/repro/models/dlrm.py:104",
}
SOURCE = {name: f"src/repro_torch/kernels/csrc/{name}.cu"
          for name in REPLACES}
SOURCE["bag_sum_backward"] = "src/repro_torch/kernels/csrc/embedding_bag.cu"


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


def profile_device(torch, step, reps: int, what: str, card: str,
                   top: int = 10) -> dict:
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
    for us, count, key in sorted(rows, reverse=True)[:top]:
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


def check_flash_decode_family(torch, card: str) -> list:
    """flash_decode at the per-layer shapes phase 12's decode cells give
    it (bf16 caches, bf16 q): each against its plain version within atol
    1e-4, timed (CUDA events) beside SDPA (GQA) and its byte bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref
    from repro_torch.kernels.flash_decode import ops as fd_ops
    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = []
    for what, b, h, kh, dh, s, kv_len in FD_FAMILY:
        def rand(*shape):
            return torch.randn(shape, generator=gen, device="cuda",
                               dtype=torch.bfloat16)
        q, k, v = rand(b, h, dh), rand(b, s, kh, dh), rand(b, s, kh, dh)
        want = flash_decode_ref(q, k, v, kv_len)
        err = (flash_decode(q, k, v, kv_len) - want).abs().max().item()
        if not err <= 1e-4:
            raise AssertionError(f"flash_decode {what}: max error {err} > "
                                 f"1e-4")
        sms, per_sm, smem, stages, form, heads = fd_ops.device_config(q, k)
        n_split, split_len = fd_ops.plan_splits(b, kh // heads, kv_len, sms,
                                                per_sm)
        iters = 5 if b * s * kh * dh > 2 ** 30 else 20
        row = {"shape": f"{what}: q [{b},{h},{dh}], caches "
                        f"[{b},{s},{kh},{dh}] bf16, kv_len {kv_len}",
               "max_abs_err": err,
               "form": f"tensor cores, dh {form}" if form else "SIMT",
               "plan": (f"{n_split} splits of {split_len}, {heads} KV heads "
                        f"a block, {b * kh // heads * n_split} blocks on "
                        f"{sms} x {per_sm}, {smem} B shared a block"),
               "ms": time_ms(torch, lambda: flash_decode(q, k, v, kv_len),
                             iters=iters)}
        row["bound_ms"], row["bound_by"] = bound(
            2.0 * b * kh * kv_len * dh * 2 + b * h * dh * 6,
            4.0 * b * h * kv_len * dh, BF16_TC_OPS_PER_S)
        qs = q.view(b, h, 1, dh)
        ks, vs = k[:, :kv_len].transpose(1, 2), v[:, :kv_len].transpose(1, 2)
        try:        # a yardstick only: a backend may refuse the shape
            row["library_ms"] = time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, enable_gqa=True), iters=iters)
        except RuntimeError as e:
            row["library_ms"] = None
            say(f"  SDPA refused {what}: {str(e).splitlines()[0][:120]}")
        say(f"flash_decode {row['shape']}: max |kernel - plain| {err:.3e} "
            f"(atol 1e-4); {row['form']}; kernel {row['ms']:.4f} ms, SDPA "
            + (f"{row['library_ms']:.4f}" if row["library_ms"] is not None
               else "n/a")
            + f" ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
            f"{row['plan']}, on {card}")
        rows.append(row)
        del q, k, v, want, qs, ks, vs
        free(torch)
    return rows


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


def fill_cache(cfg, cache, filled) -> None:
    """Copy prefill's caches into the first slots of ``cache`` (a local
    layer's rolling cache takes prefill's last min(window, S) keys at
    slots 0..w-1, as the JAX decode cell's caller does)."""
    for full, part in zip(cache, filled):
        for name in ("k", "v"):
            full[name][:, :, :part[name].shape[2]] = part[name]


def lm_serve_run(torch, params, cfg, gen, prompt_len: int,
                 cache_len: int, p_bf16: bool) -> dict:
    """Prefill LM_PROMPTS prompts of ``prompt_len`` tokens into a
    ``cache_len``-slot cache, decode LM_SERVE_STEPS greedy steps, take a
    prefill of the extended sequences at every decoded position
    (``lm_reference``), and read the check's controls (``lm_controls``,
    with the p-rounding reading if ``p_bf16``).
    Asserts nothing but the launch count and finite logits; returns every
    step's logits (``got``, [steps, B, V]), the reference's (``want``),
    the launches, the host-clock times and the controls' readings."""
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.models import transformer as tf
    prompts = torch.randint(0, cfg.vocab, (LM_PROMPTS, prompt_len),
                            generator=gen, device="cuda", dtype=torch.int32)
    flash_decode.launches = 0
    t0 = time.perf_counter()
    logits, filled = tf.prefill(params, prompts, cfg)
    cache = tf.make_cache(cfg, LM_PROMPTS, cache_len, device="cuda")
    fill_cache(cfg, cache, filled)
    del filled
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    kept = decode_slots(torch, cache, prompt_len, LM_SERVE_STEPS)
    got, inputs = lm_decode(torch, params, cfg, cache,
                            logits.argmax(-1).to(torch.int32), prompt_len,
                            LM_SERVE_STEPS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = flash_decode.launches
    if launches != cfg.n_layers * LM_SERVE_STEPS:
        raise AssertionError(f"flash_decode launched {launches} times in "
                             f"{LM_SERVE_STEPS} steps of {cfg.n_layers} "
                             f"layers")
    if not torch.isfinite(got).all():
        raise AssertionError("decode logits are not finite")
    want = lm_reference(torch, params, cfg, prompts, inputs)
    controls = lm_controls(torch, params, cfg, cache, kept, inputs, want,
                           prompt_len, p_bf16)
    return dict(got=got, want=want, launches=launches,
                prefill_s=t1 - t0, decode_s=t2 - t1, controls=controls)


def lm_serve_requests(torch, params, cfg, gen, card: str,
                      prompt_len: int = LM_PROMPT_LEN,
                      cache_len: int = LM_SERVE_CACHE,
                      bound: float = LM_REL_L2, what: str = "LM",
                      p_bf16: bool = True) -> int:
    """``lm_serve_run`` (phase 6: 4 prompts of 512 tokens, a 1024-slot
    cache, 32 steps, the p-rounding reading), then its checks: every
    step's logits within the relative L2 ``bound`` of a prefill of the
    extended sequences, the sound re-run inside it and every planted
    fault outside it.  Returns the served run's ``flash_decode``
    launches."""
    run = lm_serve_run(torch, params, cfg, gen, prompt_len, cache_len,
                       p_bf16)
    say(f"{what} serve: prefill {LM_PROMPTS}x{prompt_len} in "
        f"{run['prefill_s'] * 1e3:.1f} ms, {LM_SERVE_STEPS} greedy decode "
        f"steps ({LM_PROMPTS} requests, cache {cache_len}) in "
        f"{run['decode_s'] * 1e3:.1f} ms = "
        f"{LM_PROMPTS * LM_SERVE_STEPS / run['decode_s']:.1f} tokens/s "
        f"(host clock, on {card}); flash_decode launches {run['launches']}")
    rel = {k: r for k, (r, _) in run["controls"].items()}
    say(f"LM check controls ({LM_SERVE_STEPS} steps re-run on the served "
        f"inputs, each fault in every step; relative L2 against prefill, "
        f"bound {bound:.3e}): "
        + "; ".join(f"{k} {v:.3e}" for k, v in rel.items())
        + (" (the last not asserted)" if p_bf16 else ""))
    v = run["got"].shape[-1]
    check_decode_vs_prefill(torch, run["got"].reshape(-1, v),
                            run["want"].reshape(-1, v), bound,
                            f"bf16, {cfg.n_layers} layers, all "
                            f"{LM_SERVE_STEPS} steps")
    assert_controls(rel, bound, "relative L2")
    return run["launches"]


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


# The check's controls: label -> the fault planted in attention_decode.
# The first three hold for every cache; the two ring faults only where a
# local layer's rolling cache has wrapped (cur_len >= window), since
# before that they equal a sound step or the lost write.
LM_FAULTS = {
    "position off by one (RoPE and slot at cur_len + 1)": "position",
    "self-token dropped (the written slot not read)": "self",
    "new K/V lost (the write never lands)": "lost",
}
RING_FAULTS = {
    "ring slot off by one (new K/V at (cur_len + 1) % window)": "ring_slot",
    "ring read as a prefix (kv_len = cur_len % window + 1)": "ring_prefix",
}
P_BF16 = "p rounded to bf16 before PV"


def decode_slots(torch, cache, first: int, steps: int) -> list:
    """Before decoding from position ``first``: every cache's slots that
    ``steps`` steps from there (or from ``first + 1``, the position
    fault) can write, with their contents (zeros on a full cache; on a
    wrapped rolling cache, keys that are leaving the window), so that a
    re-run starts from the state the served run found."""
    out = []
    for c in cache:
        for t in (c["k"], c["v"]):
            n = t.shape[2]
            idx = torch.tensor(sorted({p % n for p in range(
                first, first + steps + 1)}), device=t.device)
            out.append((t, idx, t.index_select(2, idx)))
    return out


def planted_attention(torch, fault: str):
    """``attention_decode`` with ``fault`` planted.  Each fault targets
    the slot the step writes: ``cur_len`` on a full cache, ``cur_len %
    window`` on a rolling one."""
    from repro_torch.kernels.flash_decode import flash_decode

    def attend(q, k_cache, v_cache, k_new, v_new, cur_len, *, window=None):
        cur = int(cur_len)
        slot = cur if window is None else cur % window
        kv_len = cur + 1 if window is None else min(cur, window - 1) + 1
        rolled = window is not None and cur >= window
        if fault == "ring_slot" and rolled:
            slot = (cur + 1) % window
        if fault != "lost":
            k_cache[:, slot] = k_new
            v_cache[:, slot] = v_new
        if fault == "self":        # the last read slot fills the written one
            k_read, v_read = k_cache.clone(), v_cache.clone()
            k_read[:, slot] = k_cache[:, kv_len - 1]
            v_read[:, slot] = v_cache[:, kv_len - 1]
            out = flash_decode(q, k_read, v_read, kv_len - 1)
        elif fault == "ring_prefix" and rolled:
            out = flash_decode(q, k_cache, v_cache, slot + 1)
        elif fault == "p_bf16":
            out = _p_bf16_decode(torch, q, k_cache, v_cache, kv_len)
        else:
            out = flash_decode(q, k_cache, v_cache, kv_len)
        return out.to(v_cache.dtype), k_cache, v_cache
    return attend


def lm_decode(torch, params, cfg, cache, token, first: int, steps: int,
              forced=None, fault: "str | None" = None):
    """``steps`` decode steps from position ``first`` (``first + 1``
    under the position fault), the first on ``token`` [B], each later
    one on the previous step's greedy token or, given ``forced``
    ([steps, B]), on ``forced[i]`` (the controls re-run the served
    inputs).  With ``fault``, ``attention_decode`` is
    ``planted_attention(fault)`` in every step.  Returns the steps'
    logits [steps, B, V] f32 and their inputs [steps, B]."""
    from repro_torch.models import transformer as tf
    sound = tf.attention_decode
    if fault is not None:
        tf.attention_decode = planted_attention(torch, fault)
    shift = 1 if fault == "position" else 0
    logits, inputs = [], [token]
    try:
        for i in range(steps):
            out, _ = tf.decode_step(params, cache, inputs[-1],
                                    first + shift + i, cfg)
            logits.append(out)
            if i + 1 < steps:
                inputs.append(out.argmax(-1).to(torch.int32)
                              if forced is None else forced[i + 1])
    finally:
        tf.attention_decode = sound
    return torch.stack(logits), torch.stack(inputs)


def lm_reference(torch, params, cfg, prompts, inputs):
    """A prefill of the extended sequences (the prompts, then each decode
    step's input) through ``forward``, the logits at every decoded
    position: [steps, B, V] f32, step i's at position S + i."""
    from repro_torch.models import transformer as tf
    s = prompts.shape[1]
    x, _ = tf.forward(params, torch.cat([prompts, inputs.t()], dim=1), cfg)
    head = tf.lm_head_weight(params, cfg).to(cfg.compute_dtype)
    return (x[:, s:] @ head).float().transpose(0, 1)


def distance(got, want) -> "tuple[float, float]":
    """(relative L2 error over every step and row, max |diff|)."""
    d = got - want
    return (d.norm() / want.norm()).item(), d.abs().max().item()


def lm_controls(torch, params, cfg, cache, kept, inputs, want, first: int,
                p_bf16: bool) -> dict:
    """Re-run the served decode steps from the cache they found
    (``kept``, from ``decode_slots``), on the served inputs, once sound
    (which must agree with the served run) and once with each fault
    planted in every step (LM_FAULTS; RING_FAULTS where a rolling cache
    has wrapped; with ``p_bf16``, p rounded to bf16 before PV, the
    Pallas body's own rounding, which the kernel leaves out: noise of
    the bf16 path's order, read and never asserted).  Returns label ->
    ``distance`` against ``want``, "sound" first."""
    steps = inputs.shape[0]

    def rerun(fault=None):
        for t, idx, saved in kept:
            t.index_copy_(2, idx, saved)
        got, _ = lm_decode(torch, params, cfg, cache, inputs[0], first,
                           steps, forced=inputs, fault=fault)
        return distance(got, want)

    faults = dict(LM_FAULTS)
    if cfg.sliding_window is not None \
            and first + steps - 1 >= cfg.sliding_window:
        faults.update(RING_FAULTS)
    readings = {"sound": rerun()}
    for label, fault in faults.items():
        readings[label] = rerun(fault)
    if p_bf16:
        readings[P_BF16] = rerun("p_bf16")
    return readings


def assert_controls(readings: dict, bound: float, measure: str) -> None:
    """The sound re-run inside ``bound`` and every planted fault but
    P_BF16 outside it (``readings``: label -> one ``measure``)."""
    if not readings["sound"] <= bound:
        raise AssertionError(f"the re-run sound step reads "
                             f"{readings['sound']} ({measure})")
    for what, got in readings.items():
        if what not in ("sound", P_BF16) and not got > bound:
            raise AssertionError(f"planted fault '{what}' reads {got} "
                                 f"({measure}), inside the bound {bound}")


def lm_decode_32k(torch, cell, gen, w_bytes: int, kv_bytes: int,
                  card: str, steps: int = DECODE_STEPS) -> int:
    """A decode cell (decode_32k at batch 32 for glm4): fill the cache
    from the generator, time ``steps`` steps from cur_len seq_len - 8
    (32760), profile one."""
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.models import transformer as tf
    params, caches = cell.args[0], cell.args[1]
    cfg, batch, seq = cell.meta["cfg"], cell.meta["batch"], \
        cell.meta["seq_len"]
    cur0 = seq - 8
    t0 = time.perf_counter()
    for c in range(cfg.n_cycles):
        for pos in caches:
            pos["k"][c].normal_(generator=gen)
            pos["v"][c].normal_(generator=gen)
    toks = torch.randint(0, cfg.vocab, (batch,), generator=gen,
                         device="cuda", dtype=torch.int32)
    logits, _ = tf.decode_step(params, caches, toks, cur0 - 1, cfg)
    torch.cuda.synchronize()
    say(f"{cell.shape}: cache filled from the generator and one warm-up step "
        f"in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    flash_decode.launches = 0
    t0 = time.perf_counter()
    for i in range(steps):
        logits, _ = tf.decode_step(params, caches, toks, cur0 + i, cfg)
        toks = logits.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_decode.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    if launches != cfg.n_layers * steps:
        raise AssertionError(f"flash_decode launched {launches} times in "
                             f"{steps} {cell.shape} steps")
    if logits.shape != (batch, cfg.vocab) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"{cell.shape} logits are not finite [B, V]")
    # The step's byte bound: every weight but the embedding table (only B
    # rows of it), and the K/V rows each layer reads (up to cur_len, or
    # a local layer's whole rolling cache).
    emb = params["embed"]
    kv_read = sum(c[n].numel() * c[n].element_size()
                  * min(cur0 + 1, c[n].shape[2]) / c[n].shape[2]
                  for c in caches for n in ("k", "v"))
    step_bytes = (w_bytes - emb.numel() * emb.element_size()
                  + batch * cfg.d_model * emb.element_size() + kv_read)
    ms = wall / steps * 1e3
    cut = cell.meta.get("reduced", {}).get("batch")
    say(f"{cell.arch} {cell.shape}: batch {batch}"
        + (f" (cut from {cut[0]})" if cut else "")
        + f", cur_len {cur0}: {ms:.2f} ms/step, "
        f"{batch * steps / wall:.1f} tokens/s, model "
        f"{cell.model_flops / (ms / 1e3) / 1e12:.2f} TFLOP/s; byte bound "
        f"{step_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms/step "
        f"({step_bytes / 1e9:.1f} GB); peak device memory {peak:.2f} GB; "
        f"flash_decode launches {launches} (host clock, on {card})")
    profile_device(torch, lambda: tf.decode_step(params, caches, toks,
                                                 cur0, cfg),
                   2, f"{cell.shape} steps (batch {batch})", card)
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


# ------------------------------------------------------------- phase 10
def _counters() -> dict:
    from repro_torch.kernels.embedding_bag import bag_sum, bag_sum_backward
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.edge_relax import relax_sweep_
    from repro_torch.kernels.tropical_matmul import minplus
    return {"edge_relax": relax_sweep_, "tropical_matmul": minplus,
            "flash_decode": flash_decode, "embedding_bag": bag_sum,
            "bag_sum_backward": bag_sum_backward}


def paths_now() -> dict:
    """Every kernel's launch count."""
    return {name: fn.launches for name, fn in _counters().items()}


def reset_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def timed_steps(torch, step, batches) -> "tuple[list, list]":
    """Run ``step(i, batch)`` over ``batches``, each timed by CUDA events;
    returns (ms a step, the losses as floats)."""
    ms, losses = [], []
    for i, batch in enumerate(batches):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = step(i, batch)
        stop.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(stop))
        losses.append(float(loss))
    return ms, losses


def median(xs):
    return sorted(xs)[len(xs) // 2]


def bwd_violations(got, want, absum, cnt) -> int:
    """Elements of touched rows where ``got`` and ``want`` (the same f32
    terms summed in two orders, ``cnt`` terms a row) differ by more than
    BWD_SUM_SLACK * (cnt - 1) * 2**-24 * ``absum`` (the row's sum of
    |terms|): twice the a-priori bound of an f32 sum of n terms in any
    order, with room for its second-order term and for the rounding of
    ``absum``.  A row of one slot must be bit-equal."""
    tol = (BWD_SUM_SLACK * 2.0 ** -24) * (cnt - 1).float()[:, None] * absum
    return int(((got - want).abs() > tol).sum())


def check_bwd_output(torch, got, g, ids, mask, n_rows: int) -> dict:
    """Hold a dense table gradient ``got`` [n_rows, D] against
    ``bag_sum_backward_ref`` on the same inputs: every touched row within
    :func:`bwd_violations`'s bound, every untouched row zero, all finite.
    Two planted faults must break the bound: a zero output, and the rows
    whose run of sorted slots crosses a chunk boundary left at zero (what
    the kernel writes without its second pass).  Raises on a failure;
    returns what the check saw."""
    from repro_torch.kernels.embedding_bag import (backward_plan,
                                                   bag_sum_backward_ref)
    from repro_torch.kernels.embedding_bag.ops import BWD_CHUNK
    rows, _ = backward_plan(ids, n_rows)
    cnt = torch.bincount(rows.long(), minlength=n_rows + 1)[:n_rows]
    del rows
    hit = torch.nonzero(cnt).squeeze(1)          # the touched rows, in order
    stray = int(torch.count_nonzero(got, dim=1)[cnt == 0].sum())
    want = bag_sum_backward_ref(g, ids, mask, n_rows)[hit]
    absum = bag_sum_backward_ref(g.abs(), ids, mask.abs(), n_rows)[hit]
    got_h, n_h = got[hit], cnt[hit]
    max_err = (got_h - want).abs().max().item()
    bad = bwd_violations(got_h, want, absum, n_h)
    if bad or stray or not torch.isfinite(got).all():
        raise AssertionError(f"bag_sum_backward differs from the plain "
                             f"version: {bad} elements outside the bound, "
                             f"{stray} stray elements in untouched rows, "
                             f"max |err| {max_err}")
    start = torch.cumsum(cnt, 0)[hit] - n_h      # each run's first slot
    crossing = start // BWD_CHUNK != (start + n_h - 1) // BWD_CHUNK
    caught = {
        "zero output": bwd_violations(torch.zeros_like(got_h), want, absum,
                                      n_h),
        "no second pass": bwd_violations(
            got_h.masked_fill(crossing[:, None], 0.0), want, absum, n_h)}
    if not all(caught.values()):
        raise AssertionError(f"the bag_sum_backward bound misses a planted "
                             f"fault: {caught}")
    return {"max_abs_err": max_err, "touched": hit.numel(),
            "one_slot": int((n_h == 1).sum()), "hottest": int(cnt.max()),
            "crossing": int(crossing.sum()), "caught": caught,
            "max_grad_out": g.abs().max().item(),
            "max_d_table": want.abs().max().item(),
            "max_abs_sum": absum.max().item()}


def check_bag_sum_backward(torch, card: str, cell) -> dict:
    """One DLRM step's table gradient, from the kernel through autograd,
    against ``bag_sum_backward_ref`` on the same ``grad_out`` (captured
    from the Function's backward) on the card by :func:`check_bwd_output`,
    and bit-equal across two launches; timed at the train shape beside
    the plain version and ``index_add_``, the memset of the dense
    gradient timed apart."""
    from repro_torch.kernels.embedding_bag import (BagSum, backward_plan,
                                                   bag_sum_backward,
                                                   bag_sum_backward_ref)
    from repro_torch.launch.steps import dlrm_value_and_grad
    state, batch = cell.args[0], cell.args[1:]
    seen = {}
    inner = BagSum.backward

    def capture(ctx, grad_out):
        seen["grad_out"] = grad_out.contiguous()
        seen["ids"], seen["mask"] = ctx.saved_tensors
        seen["n_rows"] = ctx.n_rows
        return inner(ctx, grad_out)
    BagSum.backward = staticmethod(capture)
    try:
        _, grads = dlrm_value_and_grad(state["params"], *batch,
                                       cell.meta["cfg"])
    finally:
        BagSum.backward = staticmethod(inner)
    g, ids, mask, n_rows = (seen["grad_out"], seen["ids"], seen["mask"],
                            seen["n_rows"])
    got = grads["tables"].view(n_rows, -1)
    d = got.shape[1]
    n = ids.numel()
    chk = check_bwd_output(torch, got, g, ids, mask, n_rows)
    again = bag_sum_backward(g, ids, mask, n_rows)
    if not torch.equal(again, got):
        raise AssertionError("bag_sum_backward gave other bits at its "
                             "second launch")
    touched = chk["touched"]
    say(f"bag_sum_backward at train_batch: grad_out [{n},{d}] f32, "
        f"{touched} rows touched ({chk['one_slot']} of one slot, "
        f"bit-equal), the hottest {chk['hottest']} slots; max |grad_out| "
        f"{chk['max_grad_out']:.3e}, max |d_table| "
        f"{chk['max_d_table']:.3e}, max row sum of |terms| "
        f"{chk['max_abs_sum']:.3e}; max |err| {chk['max_abs_err']:.3e} "
        f"against the plain version (bound {BWD_SUM_SLACK} x (slots - 1) x "
        f"2^-24 x sum |terms|), untouched rows zero, bit-equal across "
        f"launches; planted faults outside the bound: a zero output "
        f"{chk['caught']['zero output']} elements, the {chk['crossing']} "
        f"rows crossing a chunk left at zero "
        f"{chk['caught']['no second pass']} elements")
    del grads, again
    free(torch)
    row = {"shape": f"grad_out [{n},{d}] f32, ids [{n},1] (Zipf), table "
                    f"[{n_rows},{d}]", "max_abs_err": chk["max_abs_err"],
           "plan": "one call = 2 kernel launches (bag_bwd_runs_kernel, then "
                   "bag_bwd_carry_kernel); launches counts calls"}
    buf = torch.zeros((n_rows, d), device="cuda")
    row["ms"] = time_ms(torch, lambda: bag_sum_backward(
        g, ids, mask, n_rows, out=buf), iters=20)
    row["parts"] = {
        "sort_ms": time_ms(torch, lambda: backward_plan(ids, n_rows),
                           iters=20),
        "memset_ms": time_ms(torch, buf.zero_, iters=10)}
    row["plain_ms"] = time_ms(torch, lambda: bag_sum_backward_ref(
        g, ids, mask, n_rows), iters=1, warmup=0)
    flat = ids.reshape(-1).long()
    src = g * mask.reshape(-1, 1)              # K = 1: one slot a bag
    row["library_ms"] = time_ms(torch, lambda: buf.index_add_(0, flat, src),
                                iters=20)
    # Bytes: grad_out's rows, ids and mask (4 B a slot each) in, each
    # touched row written once; one multiply and one add an element a slot.
    row["bound_ms"], row["bound_by"] = bound(
        4.0 * n * d + 8.0 * n + 4.0 * d * touched, 2.0 * n * d)
    say(f"bag_sum_backward: kernel {row['ms']:.4f} ms (its sort "
        f"{row['parts']['sort_ms']:.4f} ms), dense zero fill "
        f"{row['parts']['memset_ms']:.4f} "
        f"ms apart, plain {row['plain_ms']:.4f} ms, index_add_ (library) "
        f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}) on {card}")
    del buf, src, flat
    free(torch)
    return row


def drive_dlrm_train(torch, card: str) -> "tuple[dict, dict]":
    """Phase 10a: dlrm-rm2 train_batch at full size through the train
    cell, DLRM_TRAIN_STEPS steps on RecsysStream's batches.  Returns
    (bag_sum_backward's row, the counts of the counted steps)."""
    from repro_torch.launch.steps import build_cell
    t0 = time.perf_counter()
    cell = build_cell("dlrm-rm2", "train_batch", device="cuda")
    torch.cuda.synchronize()
    state = cell.args[0]
    nbytes = sum(t.numel() * t.element_size() for t in (
        state["params"]["tables"], state["opt"].m["tables"],
        state["opt"].v["tables"]))
    say(f"dlrm-rm2 train_batch: B {cell.meta['batch']}, tables "
        f"{tuple(state['params']['tables'].shape)} f32; params, m and v of "
        f"the tables {nbytes / 1e9:.2f} GB made in "
        f"{time.perf_counter() - t0:.1f} s; data {cell.meta['data']}")
    batches = [cell.args[1:]] + [cell.batch_at(i)
                                 for i in range(1, DLRM_TRAIN_STEPS)]
    ids0 = batches[0][1]
    resident = torch.cuda.memory_allocated()
    say(f"  Zipf ids: row 0 takes {float((ids0 == 0).float().mean()):.3f} "
        f"of a field's slots; {resident / 1e9:.2f} GB resident before the "
        f"steps")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ms, losses = timed_steps(
        torch, lambda i, b: cell.fn(state, *b)[1]["loss"], batches)
    counts = paths_now()
    peak = torch.cuda.max_memory_allocated()
    n = DLRM_TRAIN_STEPS
    if counts["embedding_bag"] != n or counts["bag_sum_backward"] != n:
        raise AssertionError(f"dlrm train: {counts} in {n} steps (want 1 "
                             "forward and 1 backward launch a step)")
    if not all(map(lambda x: x == x and abs(x) < float("inf"), losses)):
        raise AssertionError(f"dlrm train losses not finite: {losses}")
    say(f"dlrm-rm2 train_batch: {n} steps, losses "
        f"{[round(x, 6) for x in losses]}, median step {median(ms):.3f} ms "
        f"(CUDA events; steps {[round(x, 3) for x in ms]}), peak device "
        f"memory {peak / 1e9:.2f} GB, model "
        f"{cell.model_flops / (median(ms) / 1e3) / 1e12:.3f} TFLOP/s; "
        f"bag_sum and bag_sum_backward {n} launches each, on {card}")
    nxt = cell.batch_at(n)
    profile_device(torch, lambda: cell.fn(state, *nxt), 1,
                   "dlrm-rm2 train steps", card, top=15)
    del batches, nxt
    free(torch)
    row = check_bag_sum_backward(torch, card, cell)
    del cell, state
    free(torch)
    return row, counts


def check_grads(torch, got, want, what: str) -> float:
    """The logic checks of phases 10 and 11: each leaf of ``got`` (the
    card's) within LOGIC_RTOL and LOGIC_ATOL_SCALE of the leaf's largest
    magnitude of ``want`` (the CPU's); returns the worst error as a share
    of its leaf's scale."""
    from repro_torch.tree import flatten_with_paths, leaves
    worst = 0.0
    for (k, g), w in zip(flatten_with_paths(got), leaves(want)):
        g = g.cpu()
        scale = w.abs().max().item()
        err = (g - w).abs().max().item()
        worst = max(worst, err / max(scale, 1e-30))
        if not torch.allclose(g, w, rtol=LOGIC_RTOL,
                              atol=LOGIC_ATOL_SCALE * scale):
            raise AssertionError(f"{what} gradient {k}: max |err| {err} at "
                                 f"scale {scale}")
    return worst


def lm_train_logic(torch, arch: str = "glm4-9b", n_layers: int = 2) -> None:
    """An LM's full width (glm4-9b's) at ``n_layers`` layers in f32 on
    LM_LOGIC_SEQ tokens: the train loss (an MoE arch's aux loss in it)
    and every gradient on the card against the same model on the CPU."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import lm_value_and_grad
    from repro_torch.tree import map_tree
    cfg = dataclasses.replace(get_arch(arch).CONFIG, n_layers=n_layers,
                              compute_dtype=torch.float32,
                              loss_chunk=LM_LOGIC_SEQ // 2)
    from repro_torch.models import transformer as tf
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = tf.init_params(cfg, gen, device="cuda")
    toks = torch.randint(0, cfg.vocab, (1, LM_LOGIC_SEQ + 1), generator=gen,
                         device="cuda", dtype=torch.int32)
    x, y = toks[:, :-1].contiguous(), toks[:, 1:].contiguous()
    loss, grads = lm_value_and_grad(params, x, y, cfg)
    grads = map_tree(lambda t: t.cpu(), grads)
    loss = loss.item()
    cpu = map_tree(lambda t: t.cpu(), params)
    del params
    free(torch)
    t0 = time.perf_counter()
    want_loss, want = lm_value_and_grad(cpu, x.cpu(), y.cpu(), cfg)
    cpu_s = time.perf_counter() - t0
    worst = check_grads(torch, grads, want, "LM f32")
    if not abs(loss - want_loss.item()) <= 1e-5 * abs(want_loss.item()):
        raise AssertionError(f"LM f32 loss {loss} on the card, "
                             f"{want_loss.item()} on the CPU")
    say(f"{arch} train logic (full width, {n_layers} layers, f32, "
        f"{LM_LOGIC_SEQ} tokens): loss {loss:.6f} on the card, "
        f"{want_loss.item():.6f} on "
        f"the CPU ({cpu_s:.1f} s); every gradient within rtol "
        f"{LOGIC_RTOL}, atol {LOGIC_ATOL_SCALE} of its scale (worst "
        f"{worst:.2e} of it)")


def drive_lm_train(torch, card: str) -> dict:
    """Phase 10b: the f32 logic check, then glm4-9b train_4k at full
    width, depth and batch cut to fit one card, bf16 compute, remat on.
    Returns the launch counts of the counted steps."""
    from repro_torch.configs import glm4_9b
    from repro_torch.launch.steps import build_cell, lm_train_layers
    lm_train_logic(torch)
    free(torch)
    free_bytes = torch.cuda.mem_get_info()[0]
    layers = lm_train_layers(glm4_9b.CONFIG, free_bytes, LM_TRAIN_RESERVE)
    t0 = time.perf_counter()
    cell = build_cell("glm4-9b", "train_4k", device="cuda",
                      batch=LM_TRAIN_BATCH, layers=layers)
    torch.cuda.synchronize()
    cfg, state = cell.meta["cfg"], cell.args[0]
    n_params = cfg.param_count()
    resident = torch.cuda.memory_allocated()
    say(f"glm4-9b train_4k: cuts {cell.meta['reduced']} (depth: "
        f"{free_bytes / 1e9:.2f} GB free, 16 B a parameter, "
        f"{LM_TRAIN_RESERVE / 2 ** 30:.0f} GiB kept for activations); "
        f"{n_params / 1e9:.3f} B params, f32 state "
        f"{16 * n_params / 1e9:.2f} GB with the gradients; d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}, heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads}, d_ff {cfg.d_ff}, {cfg.compute_dtype}, remat "
        f"{cfg.remat}; made in {time.perf_counter() - t0:.1f} s, "
        f"{resident / 1e9:.2f} GB resident")
    batches = [cell.batch_at(i) for i in range(LM_TRAIN_STEPS + 1)]
    warm_ms, warm_loss = timed_steps(
        torch, lambda i, b: cell.fn(state, *b)[1]["loss"], batches[:1])
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ms, losses = timed_steps(
        torch, lambda i, b: cell.fn(state, *b)[1]["loss"], batches[1:])
    counts = paths_now()
    peak = torch.cuda.max_memory_allocated()
    if not all(x == x and abs(x) < float("inf")
               for x in warm_loss + losses):
        raise AssertionError(f"LM train losses not finite: {losses}")
    tokens = LM_TRAIN_BATCH * cell.meta["seq_len"]
    say(f"glm4-9b train_4k: {LM_TRAIN_STEPS} steps after a warm-up "
        f"({warm_ms[0]:.1f} ms), losses "
        f"{[round(x, 5) for x in warm_loss + losses]}, median step "
        f"{median(ms):.1f} ms (CUDA events; {[round(x, 1) for x in ms]}), "
        f"{tokens / (median(ms) / 1e3):.0f} tokens/s, model "
        f"{cell.model_flops / (median(ms) / 1e3) / 1e12:.1f} TFLOP/s, peak "
        f"device memory {peak / 1e9:.2f} GB of "
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f}, "
        f"on {card}")
    nxt = cell.batch_at(LM_TRAIN_STEPS + 1)
    profile_device(torch, lambda: cell.fn(state, *nxt), 1,
                   "glm4-9b train_4k steps", card, top=15)
    del cell, state, batches, nxt
    free(torch)
    return counts


def resume_check(torch, arch: str, shape: str, root: str) -> None:
    """Phase 10c: the smoke config of ``arch`` on the card, RESUME_STEPS
    steps uninterrupted and under ``ElasticTrainer`` with a failure
    injected before step RESUME_FAIL (checkpoints every RESUME_EVERY,
    restored from the manifest alone): final params and OptState equal
    bit for bit."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.ft import ElasticTrainer
    from repro_torch.launch.steps import build_cell
    from repro_torch.optim import OptState
    from repro_torch.tree import flatten_with_paths, map_tree
    cell = build_cell(arch, shape, smoke=True, device="cuda")
    init = map_tree(lambda t: t.clone(), cell.args[0])

    def step_fn(state, step):
        return cell.fn(state, *cell.batch_at(step))[0]

    whole = map_tree(lambda t: t.clone(), init)
    for step in range(RESUME_STEPS):
        whole = step_fn(whole, step)

    def build(n_devices, restored):
        if restored is None:
            return map_tree(lambda t: t.clone(), init), step_fn
        on = map_tree(lambda t: t.to("cuda"), restored)
        return {"params": on["params"], "opt": OptState(**on["opt"])}, \
            step_fn
    failed = []

    def injector(step):
        if step == RESUME_FAIL and not failed:
            failed.append(step)
            raise RuntimeError(f"injected failure at step {step}")
    mgr = CheckpointManager(os.path.join(root, arch), keep_last=2)
    state, log = ElasticTrainer(ckpt=mgr, build=build,
                                total_steps=RESUME_STEPS,
                                ckpt_every=RESUME_EVERY,
                                failure_injector=injector).run(1)
    torch.cuda.synchronize()
    diff = [k for (k, a), (_, b) in zip(flatten_with_paths(state),
                                        flatten_with_paths(whole))
            if a.dtype != b.dtype or not torch.equal(a, b)]
    saved = max(s for s in range(RESUME_FAIL) if (s + 1) % RESUME_EVERY == 0)
    if log["restarts"] != 1 or log["resumed_from"] != [saved] or diff:
        raise AssertionError(f"{arch} resume: {log}, leaves differing from "
                             f"the uninterrupted run: {diff}")
    say(f"{arch} {shape} (smoke) resume on the card: {RESUME_STEPS} steps, "
        f"a failure before step {RESUME_FAIL}, resumed from step "
        f"{log['resumed_from'][0]}; final params and OptState (count "
        f"{int(state['opt'].count)}) equal the uninterrupted run's bit for "
        f"bit ({len(flatten_with_paths(state))} leaves)")


def drive_train(torch, card: str) -> "tuple[dict, dict]":
    """Phase 10: returns (bag_sum_backward's row, launch counts of the
    dlrm_train and lm_train paths)."""
    row, dlrm_counts = drive_dlrm_train(torch, card)
    lm_counts = drive_lm_train(torch, card)
    root = tempfile.mkdtemp(prefix="train_ckpt_")
    try:
        for arch, shape in (("dlrm-rm2", "train_batch"),
                            ("glm4-9b", "train_4k")):
            resume_check(torch, arch, shape, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    free(torch)
    return row, {"dlrm_train": dlrm_counts, "lm_train": lm_counts}

# ------------------------------------------------------------- phase 11
def gnn_logic_cases(np):
    """(what, arch, config, graph on the CPU) for the logic check: every
    arch at its published width (Equiformer's depth cut) on small graphs,
    GCN also chunked, GIN on a sampled block (sentinel-padded edges)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.configs.shapes import SHAPE_PARAMS
    from repro_torch.data import (NeighborSampler, csr_from_edges,
                                  make_graph_batch, synth_molecule_batch)
    from repro_torch.launch.steps import _gnn_cell_config
    sp = SHAPE_PARAMS["gnn"]
    cora = make_graph_batch(2708, 10556, 1433, n_classes=7, device="cpu")
    gcn = _gnn_cell_config("gcn-cora", get_arch("gcn-cora").CONFIG,
                           sp["full_graph_sm"], smoke=False)
    rng = np.random.default_rng(11)
    n, e = 5000, 60000
    ptr, nbr = csr_from_edges(n, rng.integers(0, n, e), rng.integers(0, n, e))
    block = NeighborSampler(
        ptr, nbr, rng.standard_normal((n, 602), dtype=np.float32),
        rng.integers(0, 41, n).astype(np.int32), device="cpu").sample(
            rng.choice(n, 64, replace=False), step=0)
    gin = _gnn_cell_config("gin-tu", get_arch("gin-tu").CONFIG,
                           sp["minibatch_lg"], smoke=False)
    mol = synth_molecule_batch(batch=GNN_LOGIC_MOLECULES, device="cpu")
    sch = dataclasses.replace(_gnn_cell_config(
        "schnet", get_arch("schnet").CONFIG, sp["molecule"], smoke=False),
        d_in=0)
    eq = dataclasses.replace(_gnn_cell_config(
        "equiformer-v2", get_arch("equiformer-v2").CONFIG, sp["molecule"],
        smoke=False), d_in=0, n_layers=GNN_LOGIC_EQ_LAYERS)
    return [("gcn-cora on Cora's shape", "gcn-cora", gcn, cora),
            ("gcn-cora in 3 chunks", "gcn-cora",
             dataclasses.replace(gcn, edge_chunk=4096), cora),
            ("gin-tu on a 64-node sampled block", "gin-tu", gin, block),
            (f"schnet on {GNN_LOGIC_MOLECULES} molecules", "schnet", sch,
             mol),
            (f"equiformer-v2 at {GNN_LOGIC_EQ_LAYERS} layers on "
             f"{GNN_LOGIC_MOLECULES} molecules", "equiformer-v2", eq, mol)]


def gnn_logic(np, torch) -> None:
    """Phase 11a: each arch's loss and every gradient on the card against
    the same model on the CPU (f32, the card without TF32)."""
    from repro_torch.launch.steps import GNN_MODULES, value_and_grad
    from repro_torch.tree import map_tree
    for what, arch, cfg, g in gnn_logic_cases(np):
        model = GNN_MODULES[arch]
        gen = torch.Generator(device="cuda").manual_seed(5)
        params = model.init_params(cfg, gen, "cuda")
        gc = g.to("cuda")
        loss, grads = value_and_grad(lambda p: model.loss_fn(p, gc, cfg),
                                     params)
        cpu = map_tree(lambda t: t.cpu(), params)
        want_loss, want = value_and_grad(
            lambda p: model.loss_fn(p, g, cfg), cpu)
        worst = check_grads(torch, grads, want, what)
        loss, want_loss = loss.item(), want_loss.item()
        if not abs(loss - want_loss) <= 1e-5 * abs(want_loss):
            raise AssertionError(f"{what}: loss {loss} on the card, "
                                 f"{want_loss} on the CPU")
        say(f"gnn logic, {what} (published width): loss {loss:.6f} on the "
            f"card, {want_loss:.6f} on the CPU; every gradient within rtol "
            f"{LOGIC_RTOL}, atol {LOGIC_ATOL_SCALE} of its scale (worst "
            f"{worst:.2e} of it)")
        del params, grads, gc
    free(torch)


def check_chunked(torch, cell, card: str) -> None:
    """Phase 11c: gcn-cora x ogb_products, the chunked forward (the cell's
    edge_chunk) against one unchunked pass over all the edges."""
    import dataclasses
    from repro_torch.models.gnn import gcn
    cfg, g = cell.meta["cfg"], cell.args[1]
    params = cell.args[0]["params"]
    with torch.no_grad():
        a = gcn.forward(params, g, cfg)
        b = gcn.forward(params, g, dataclasses.replace(cfg, edge_chunk=0))
    scale = b.abs().max().item()
    err = (a - b).abs().max().item()
    if not torch.allclose(a, b, rtol=GNN_CHUNK_RTOL,
                          atol=GNN_CHUNK_ATOL_SCALE * scale):
        raise AssertionError(f"ogb_products chunked vs unchunked: max |err| "
                             f"{err} at scale {scale}")
    n_chunks = -(-g.src.shape[0] // cfg.edge_chunk)
    say(f"gcn-cora ogb_products: {n_chunks} chunks of {cfg.edge_chunk} edges "
        f"equal one unchunked pass within rtol {GNN_CHUNK_RTOL}, atol "
        f"{GNN_CHUNK_ATOL_SCALE} of the largest output (max |err| "
        f"{err:.3e} at {scale:.3e}), on {card}")
    del a, b


def gnn_cell_run(torch, card: str, arch: str, shape: str) -> None:
    """Phase 11b: one full-width cell, a warm-up step and GNN_STEPS counted
    ones on its batches; losses finite, every parameter that gets a
    gradient moved; median step, model TFLOP/s, peak memory."""
    from repro_torch.launch.steps import build_cell
    from repro_torch.tree import flatten_with_paths, leaves
    t0 = time.perf_counter()
    cell = build_cell(arch, shape, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg, state, meta = cell.meta["cfg"], cell.args[0], cell.meta
    p0 = [p.clone() for p in leaves(state["params"])]
    t0 = time.perf_counter()
    batches = [cell.batch_at(i) for i in range(1, GNN_STEPS + 1)]
    torch.cuda.synchronize()
    batch_s = (time.perf_counter() - t0) / GNN_STEPS
    graph = (f"{meta['n_nodes']:,} nodes, {meta['n_edges']:,} edges"
             + (f" (a block of the {meta['host_graph'][0]:,}-node, "
                f"{meta['host_graph'][1]:,}-edge host graph)"
                if "host_graph" in meta else ""))
    say(f"{arch} {shape}: {graph}, data {meta['data']}; built in "
        f"{build_s:.1f} s, a later batch in {batch_s:.3f} s (host); "
        f"{sum(p.numel() for p in p0):,} params; {cfg}")
    warm_ms, warm_loss = timed_steps(
        torch, lambda i, b: cell.fn(state, *b)[1]["loss"], [cell.args[1:]])
    torch.cuda.reset_peak_memory_stats()
    ms, losses = timed_steps(
        torch, lambda i, b: cell.fn(state, *b)[1]["loss"], batches)
    peak = torch.cuda.max_memory_allocated()
    if not all(x == x and abs(x) < float("inf") for x in warm_loss + losses):
        raise AssertionError(f"{arch} {shape} losses not finite: {losses}")
    # a leaf moves iff a gradient reached it (AdamW's m is nonzero)
    dead, still = [], []
    for (k, p), a, m in zip(flatten_with_paths(state["params"]), p0,
                            leaves(state["opt"].m)):
        if not m.any():
            dead.append(k)
        elif torch.equal(p, a):
            still.append(k)
    if still or len(dead) == len(p0):
        raise AssertionError(f"{arch} {shape}: parameters with a gradient "
                             f"that did not move: {still}; without one: "
                             f"{dead}")
    tflops = cell.model_flops / (median(ms) / 1e3) / 1e12
    say(f"{arch} {shape}: {GNN_STEPS} steps after a warm-up "
        f"({warm_ms[0]:.1f} ms), losses "
        f"{[round(x, 5) for x in warm_loss + losses]}, median step "
        f"{median(ms):.3f} ms (CUDA events; {[round(x, 3) for x in ms]}), "
        f"model {tflops:.3f} TFLOP/s ({cell.model_flops / 1e9:.2f} GFLOP a "
        f"step), peak device memory {peak / 1e9:.3f} GB; "
        f"{len(p0) - len(dead)} of {len(p0)} leaves got a gradient and "
        f"moved" + (f" (no gradient reaches {dead})" if dead else "")
        + f", on {card}")
    if (arch, shape) in GNN_PROFILED:
        profile_device(torch, lambda: cell.fn(state, *batches[-1]), 1,
                       f"{arch} {shape} steps", card, top=12)
    if (arch, shape) == ("gcn-cora", "ogb_products"):
        check_chunked(torch, cell, card)
    del cell, state, batches, p0
    free(torch)


def drive_gnn(np, torch, card: str) -> dict:
    """Phase 11: the logic check, the five full-width cells (launch counts
    zeroed before the first and read after the last: the gnn_train
    path), chunked against unchunked.  Returns the counts."""
    gnn_logic(np, torch)
    reset_counts()
    for arch, shape in GNN_CELLS:
        gnn_cell_run(torch, card, arch, shape)
    counts = paths_now()
    say(f"gnn_train launches of the port's kernels: {counts} (the GNN "
        "family reaches no TPU kernel)")
    return counts


# ------------------------------------------------------------- phase 12
class DropCount:
    """While active, every ``moe_route`` call (``moe_block`` calls it)
    records its dropped and routed choices as device tensors, so the
    run is not synced; ``per_call()`` reads them after."""

    def __enter__(self):
        from repro_torch.models import layers
        self._layers, self._route, self.calls = layers, layers.moe_route, []

        def counted(xt, router_w, cfg):
            r = self._route(xt, router_w, cfg)
            self.calls.append(((~r.keep).sum(), r.keep.numel()))
            return r
        layers.moe_route = counted
        return self

    def __exit__(self, *exc):
        self._layers.moe_route = self._route

    def per_call(self) -> "list[tuple[int, int]]":
        return [(int(d), n) for d, n in self.calls]


def no_drops(cfg):
    """``cfg`` with a capacity factor of E / k: an expert has room for
    every token, so no MoE layer drops one in any pass."""
    import dataclasses
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


def tree_bytes(tree) -> int:
    from repro_torch.tree import leaves
    return sum(a.numel() * a.element_size() for a in leaves(tree))


def family_f32_logic(torch, arch: str, spec: dict) -> None:
    """Phase 12 (1): the arch's full width at a shallow depth (2 layers;
    gemma3 one 6-layer cycle) in f32: both of 2 greedy decode steps after
    a 4-prompt prefill equal a prefill of the extended sequences at atol
    LM_F32_ATOL.  An MoE arch runs at a capacity factor of E / k and
    must drop nothing (prefill's B x (S + 1) tokens and decode's B get
    other capacities, so under drops the identity fails even when the
    code is right).  gemma3's prompt is one window (1,024): decode wraps
    its rolling caches, and decode equals prefill only when the prompt
    is at most the window or a multiple of it (the reference's fault
    after any other length, ROADMAP.md queue 3).  The two steps are then
    re-run on the same inputs, once sound, which must stay inside the
    atol, and once with each fault of ``lm_controls`` planted in every
    step (gemma3's ring faults included), each of which must put a logit
    outside it."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.models import transformer as tf
    cfg = no_drops(dataclasses.replace(
        get_arch(arch).CONFIG, n_layers=spec["logic_layers"],
        compute_dtype=torch.float32))
    s = spec["logic_prompt"]
    gen = torch.Generator(device="cuda").manual_seed(2)
    params = tf.init_params(cfg, gen, device="cuda", dtype=torch.float32)
    prompts = torch.randint(0, cfg.vocab, (4, s), generator=gen,
                            device="cuda", dtype=torch.int32)
    with DropCount() as drops:
        logits, filled = tf.prefill(params, prompts, cfg)
        cache = tf.make_cache(cfg, 4, s + 16, dtype=torch.float32,
                              device="cuda")
        fill_cache(cfg, cache, filled)
        del filled
        kept = decode_slots(torch, cache, s, 2)
        flash_decode.launches = 0
        got, inputs = lm_decode(torch, params, cfg, cache,
                                logits.argmax(-1).to(torch.int32), s, 2)
        torch.cuda.synchronize()
        launches = flash_decode.launches
        want = lm_reference(torch, params, cfg, prompts, inputs)
        controls = lm_controls(torch, params, cfg, cache, kept, inputs,
                               want, s, p_bf16=False)
    dropped = sum(d for d, _ in drops.per_call())
    if launches != 2 * cfg.n_layers:
        raise AssertionError(f"{arch}: flash_decode launched {launches} "
                             f"times in the f32 run")
    if dropped:
        raise AssertionError(f"{arch}: {dropped} MoE choices dropped at "
                             f"capacity factor E / k")
    worst = {k: d for k, (_, d) in controls.items()}
    say(f"{arch} f32 check controls (2 steps re-run on the served inputs, "
        f"each fault in every step; max |diff| against prefill, atol "
        f"{LM_F32_ATOL}): "
        + "; ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    check_decode_vs_prefill(
        torch, got.reshape(-1, got.shape[-1]),
        want.reshape(-1, got.shape[-1]), 1.0,
        f"{arch}, f32, full width, {cfg.n_layers} layers, prompt {s}, both "
        f"steps" + (f", {len(drops.calls)} MoE calls, 0 dropped"
                    if cfg.moe else ""),
        atol=LM_F32_ATOL)
    assert_controls(worst, LM_F32_ATOL, "max |diff|")


def family_decode_drops(torch, cell) -> None:
    """The share of choices dropped in each MoE layer of one more
    decode step at the published capacity factor (untimed)."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import moe_capacity
    params, caches, cfg = cell.args[0], cell.args[1], cell.meta["cfg"]
    b = cell.meta["batch"]
    gen = torch.Generator(device="cuda").manual_seed(4)
    toks = torch.randint(0, cfg.vocab, (b,), device="cuda", generator=gen)
    with DropCount() as drops:
        tf.decode_step(params, caches, toks, cell.meta["seq_len"] - 8, cfg)
    share = [d / n for d, n in drops.per_call()]
    say(f"{cell.arch} {cell.shape}: dropped share per MoE layer at capacity "
        f"factor {cfg.moe.capacity_factor} (batch {b}, capacity "
        f"{moe_capacity(b, cfg.moe)} an expert): mean "
        f"{sum(share) / len(share):.4f}, max {max(share):.4f}, "
        f"{[round(x, 3) for x in share]}")


def family_serve(torch, arch: str, spec: dict, card: str) -> dict:
    """Phase 12 (2) and (3): the full-depth bf16 model (decode_32k's
    cell, its batch cut to spec["decode_batch"]) serves LM_PROMPTS
    greedy requests held to a prefill of the extended sequences (an MoE
    arch at a capacity factor of E / k, nothing dropped), then the
    decode cell itself: KV from the generator, FAMILY_DECODE_STEPS timed
    steps, a profile, the MoE drop share at the published capacity
    factor.  An arch that runs long_500k (gemma3) then runs it at batch
    1.  Returns the launch counts of each path."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import build_cell
    counts = {}
    t0 = time.perf_counter()
    cell = build_cell(arch, "decode_32k", device="cuda",
                      batch=spec["decode_batch"])
    torch.cuda.synchronize()
    params, cfg = cell.args[0], cell.meta["cfg"]
    w_bytes = tree_bytes(params)
    kv_bytes = tree_bytes(cell.args[1])
    say(f"{arch}: {cfg.n_layers} layers, {cfg.param_count() / 1e9:.3f} B "
        f"params ({cfg.active_param_count() / 1e9:.3f} B active), "
        f"{w_bytes / 1e9:.2f} GB bf16 weights and a {kv_bytes / 1e9:.2f} GB "
        f"decode_32k cache (batch {cell.meta['batch']}; cuts "
        f"{cell.meta.get('reduced')}) made on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(1)
    reset_counts()
    with DropCount() as drops:
        served = lm_serve_requests(torch, params, no_drops(cfg), gen, card,
                                   spec["prompt"], spec["cache"],
                                   spec["rel_l2"], arch, p_bf16=False)
    # the served run's count (the controls' re-runs launch more)
    counts[f"{arch}_serve"] = dict(paths_now(), flash_decode=served)
    if cfg.moe is not None:
        dropped = sum(d for d, _ in drops.per_call())
        if dropped:
            raise AssertionError(f"{arch} serve: {dropped} MoE choices "
                                 f"dropped at capacity factor E / k")
    free(torch)
    # the timed steps' count (lm_decode_32k zeroes it before them; its
    # warm-up and profile launch more)
    reset_counts()
    timed = lm_decode_32k(torch, cell, gen, w_bytes, kv_bytes, card,
                          steps=FAMILY_DECODE_STEPS)
    counts[f"{arch}_decode_32k"] = dict(paths_now(), flash_decode=timed)
    if cfg.moe is not None:
        family_decode_drops(torch, cell)
    del cell, params
    free(torch)
    if "long_500k" not in get_arch(arch).SKIP_SHAPES:
        t0 = time.perf_counter()
        cell = build_cell(arch, "long_500k", device="cuda")
        torch.cuda.synchronize()
        say(f"{arch} long_500k: batch {cell.meta['batch']}, "
            f"{tree_bytes(cell.args[1]) / 1e9:.2f} GB of caches (global "
            f"layers {cell.meta['seq_len']} slots, local "
            f"{cfg.sliding_window}), made in {time.perf_counter() - t0:.1f} s")
        reset_counts()
        timed = lm_decode_32k(torch, cell, gen, tree_bytes(cell.args[0]),
                              tree_bytes(cell.args[1]), card,
                              steps=FAMILY_DECODE_STEPS)
        counts[f"{arch}_long_500k"] = dict(paths_now(), flash_decode=timed)
        del cell
        free(torch)
    return counts


def family_train(torch, arch: str, spec: dict, card: str) -> dict:
    """Phase 12 (4): train_4k through the train cell at
    ``lm_train_layers``'s depth (whole cycles) and batch 1 x 4,096: a
    warm-up step and FAMILY_TRAIN_STEPS counted ones, losses finite,
    median step, peak memory, a profile.  Returns the counted steps'
    launch counts."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import build_cell, lm_train_layers
    free_bytes = torch.cuda.mem_get_info()[0]
    layers = lm_train_layers(get_arch(arch).CONFIG, free_bytes,
                             spec["train_reserve"])
    t0 = time.perf_counter()
    cell = build_cell(arch, "train_4k", device="cuda", batch=LM_TRAIN_BATCH,
                      layers=layers)
    torch.cuda.synchronize()
    cfg, state = cell.meta["cfg"], cell.args[0]
    n_params = cfg.param_count()
    say(f"{arch} train_4k: cuts {cell.meta['reduced']} (depth: "
        f"{free_bytes / 1e9:.2f} GB free, 16 B a parameter, "
        f"{spec['train_reserve'] / 2 ** 30:.0f} GiB kept for activations); "
        f"{n_params / 1e9:.3f} B params, f32 state "
        f"{16 * n_params / 1e9:.2f} GB with the gradients; made in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB resident")
    batches = [cell.batch_at(i) for i in range(FAMILY_TRAIN_STEPS + 1)]
    warm_ms, warm_loss = timed_steps(
        torch, lambda i, b: cell.fn(state, *b)[1]["loss"], batches[:1])
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ms, losses = timed_steps(
        torch, lambda i, b: cell.fn(state, *b)[1]["loss"], batches[1:])
    counts = paths_now()
    peak = torch.cuda.max_memory_allocated()
    if not all(x == x and abs(x) < float("inf")
               for x in warm_loss + losses):
        raise AssertionError(f"{arch} train losses not finite: {losses}")
    tokens = LM_TRAIN_BATCH * cell.meta["seq_len"]
    say(f"{arch} train_4k: {FAMILY_TRAIN_STEPS} steps after a warm-up "
        f"({warm_ms[0]:.1f} ms), losses "
        f"{[round(x, 5) for x in warm_loss + losses]}, median step "
        f"{median(ms):.1f} ms (CUDA events; {[round(x, 1) for x in ms]}), "
        f"{tokens / (median(ms) / 1e3):.0f} tokens/s, model "
        f"{cell.model_flops / (median(ms) / 1e3) / 1e12:.1f} TFLOP/s, peak "
        f"device memory {peak / 1e9:.2f} GB of "
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f}, "
        f"on {card}")
    nxt = cell.batch_at(FAMILY_TRAIN_STEPS + 1)
    profile_device(torch, lambda: cell.fn(state, *nxt), 1,
                   f"{arch} train_4k steps", card, top=12)
    del cell, state, batches, nxt
    free(torch)
    return counts


def drive_family(torch, card: str) -> dict:
    """Phase 12: the rest of the LM family, an arch at a time, each path
    freeing its memory before the next.  Returns the launch counts of
    each served and trained path."""
    paths = {}
    t_phase = time.perf_counter()
    for arch, spec in FAMILY.items():
        took = [time.perf_counter()]
        family_f32_logic(torch, arch, spec)
        free(torch)
        took.append(time.perf_counter())
        paths.update(family_serve(torch, arch, spec, card))
        took.append(time.perf_counter())
        if arch in FAMILY_GRAD_CHECK:
            lm_train_logic(torch, arch, spec["logic_layers"])
            free(torch)
        took.append(time.perf_counter())
        paths[f"{arch}_train"] = family_train(torch, arch, spec, card)
        took.append(time.perf_counter())
        parts = [b - a for a, b in zip(took, took[1:])]
        say(f"{arch} took {took[-1] - took[0]:.1f} s (f32 logic "
            f"{parts[0]:.1f}, serve and decode {parts[1]:.1f}, gradient "
            f"check {parts[2]:.1f}, train {parts[3]:.1f})")
    say(f"phase 12 (the rest of the LM family) took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return paths


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
    rows["flash_decode"]["shapes"] = check_flash_decode_family(torch, card)
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
    t0 = time.perf_counter()
    rows["bag_sum_backward"], train_paths = drive_train(torch, card)
    paths["bag_sum_backward"] = {}
    for path, counts in train_paths.items():
        for name, n in counts.items():
            paths[name][path] = n
    say(f"training phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, n in drive_gnn(np, torch, card).items():
        paths[name]["gnn_train"] = n
    say(f"GNN phase took {time.perf_counter() - t0:.1f} s")
    for path, counts in drive_family(torch, card).items():
        for name, n in counts.items():
            paths[name][path] = n
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
            "source": SOURCE[name],
            "replaces": REPLACES[name],
            "launches": paths[name][MAIN_PATH[name]],
            "main_path": MAIN_PATH[name], "launches_by_path": paths[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
            "shape": r["shape"], "plan": r.get("plan"),
            "parts": r.get("parts"), "shapes": r.get("shapes")})
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
