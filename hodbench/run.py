#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once on the card and print one JSON
result line.

    python3 hodbench/run.py --workload road-ssd --seed 7 --seconds 10 --trace 0

From the root of a checkout.  The run makes the graph's arcs from
``--seed`` with the frozen generator its configuration names, hands them
to ``repro_torch`` (``from_edges`` -> ``build_hod_fast`` -> ``pack_index``
with the core closed on the card -> ``QueryEngine`` -> ``QueryServer``),
warms the server up, and drives the mix's traffic through
``QueryServer.submit``: set-up, then the window of ``--seconds``.  Once
the window has closed it reads the peak of device memory, frees the
program's state, and holds a sample of the served answer rows to the
plain reference.  With ``--trace 0`` the metrics are the cell's
end-to-end ones; with ``--trace 1`` its per-layer ones, from
``torch.profiler`` over the window and the benchmark's own host spans.

Standard error ends with each number compared beside its limit; the
result line carries them last, under ``checks``.  Exit codes: 0 with a
result printed; 2 without a card (or with fewer than the cell needs);
3 when JAX or the JAX package was loaded.
"""
import time

_T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import asyncio  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: Top-level module names the process must not hold once the window has
#: closed, compared whole (``repro_torch`` is not ``repro``).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: The engine's query methods a traced run times as ``engine.<name>``.
ENGINE_CALLS = ("ssd", "sssp")


def _process_age() -> float:
    """Seconds since this process started (interpreter start-up and the
    imports before ``_T_IMPORT``), from ``/proc``; 0 where unreadable."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        age = up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return 0.0
    return age if 0.0 <= age < 60.0 else 0.0


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def seed_streams(seed: int):
    """The run's independent streams (graph, traffic, sample) from
    ``--seed``."""
    import numpy as np
    return np.random.SeedSequence(seed % 2 ** 64).spawn(3)


def _wrap_engine(engine, spans: list) -> None:
    """Time the engine's query calls as host spans ``engine.<name>``, on
    the instance: the program's code is unchanged."""
    for name in ENGINE_CALLS:
        fn = getattr(engine, name, None)
        if fn is None:
            continue

        def timed(*a, _fn=fn, _label=f"engine.{name}", **kw):
            t0 = time.time_ns()
            try:
                return _fn(*a, **kw)
            finally:
                spans.append((_label, t0, time.time_ns()))
        setattr(engine, name, timed)


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    try:
        return float(out.stdout.split()[0])
    except (IndexError, ValueError):
        return None


def run_cell(root: Path, bench: dict, cell, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: float = None,
             log=sys.stderr) -> dict:
    """One run of ``cell``; returns the result line as a dict.  ``device``
    ``"cpu"`` runs the port's plain CPU paths (tests only: no device
    metric is written)."""
    import numpy as np
    import torch

    from hodbench import devtrace, loadgen, spec, verdict

    t_start = time.perf_counter() if t_start is None else t_start
    cfg, mix = cell.config, cell.traffic
    on_card = device != "cpu"
    s_graph, s_traffic, s_keep = seed_streams(seed)

    gen = spec.load_module(spec.find(root, bench, "graphs",
                                     f"{cfg['graph']['kind']}.py"))
    n, src, dst, w = gen.edges(cfg["graph"], np.random.default_rng(s_graph))

    from repro_torch.core.build import BuildConfig
    from repro_torch.core.build_fast import build_hod_fast
    from repro_torch.core.graph import from_edges
    from repro_torch.core.index import pack_index
    from repro_torch.core.query import QueryEngine
    from repro_torch.launch.serve import QueryServer

    g = from_edges(n, src, dst, w)
    t0 = time.perf_counter()
    res = build_hod_fast(g, BuildConfig(**cfg["build"]))
    t1 = time.perf_counter()
    ix = pack_index(g, res, device=device, **cfg["pack"])
    t2 = time.perf_counter()
    build_s, pack_s = t1 - t0, t2 - t1
    print(f"graph n={g.n} arcs={g.m}; core {ix.n_core}, {ix.n_levels} "
          f"levels; build {build_s:.2f} s, pack {pack_s:.2f} s",
          file=log, flush=True)
    del res, g

    engine = QueryEngine(ix, device=device)
    server = QueryServer(engine, mode=mix["mode"], **cfg["server"])
    server.warmup()
    sources = loadgen.draw_sources(mix["sources"], n,
                                   np.random.default_rng(s_traffic))
    spans = [] if trace else None
    dtrace = None
    if trace:
        _wrap_engine(engine, spans)
        if on_card:
            dtrace = devtrace.DeviceTrace()
            dtrace.start()
    drive = loadgen.Drive(server, mix, sources,
                          seed=int(s_keep.generate_state(1)[0]), spans=spans)
    asyncio.run(drive.run(float(mix["warmup_seconds"]), seconds))
    events = dtrace.stop() if dtrace is not None else None
    peak = torch.cuda.max_memory_allocated() if on_card else None

    window_s = drive.w1 - drive.w0
    ctx = types.SimpleNamespace(
        mode=mix["mode"], window_s=window_s,
        setup_s=drive.w0 - t_start, build_s=build_s, pack_s=pack_s,
        latencies=np.asarray(drive.latencies), answered=drive.answered,
        stats0=drive.stats0, stats1=drive.stats1, index=ix,
        batch_size=server.batch_size, events=None, trace_window_s=None)
    breakdown = None
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": 1 if on_card else 0, "memory_peak_bytes": peak}
    if events is not None:
        ctx.events = devtrace.clip(events, drive.w0_ns, drive.w1_ns)
        ctx.trace_window_s = (drive.w1_ns - drive.w0_ns) / 1e9
        gaps, inside = devtrace.idle_by_host(ctx.events, spans,
                                             drive.w0_ns, drive.w1_ns)
        dev["busy_s"] = devtrace.busy_ns(ctx.events) / 1e9
        dev["window_s"] = ctx.trace_window_s
        breakdown = {"device_ops": devtrace.top_ops(ctx.events),
                     "idle_gaps": gaps}
        print(f"device events {len(ctx.events)} in the window; share of "
              f"device busy time inside engine calls {inside}",
              file=log, flush=True)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = spec.load_module(spec.find(
            root, bench, "metrics", f"{m['name']}.py")).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # The program's state goes before the reference runs on the card.
    server.close()
    del server, engine, ix, ctx
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t3 = time.perf_counter()
    numbers = verdict.check_answers(drive.kept, mix["mode"], n, src, dst, w,
                                    device)
    numbers["failed"] = drive.failed
    correct, checks = verdict.judge(
        numbers, min(drive.want, len(drive.latencies)))
    correct &= drive.attempted > 0
    rates = [drive.per_second[i] for i in sorted(drive.per_second)]
    print(f"window {window_s:.3f} s: {drive.attempted} requests, "
          f"{drive.answered} answered in it, {drive.failed} failed "
          f"{drive.errors}; reference {time.perf_counter() - t3:.2f} s; "
          f"answers a second {rates}", file=log, flush=True)
    if on_card:
        dev["power_limit_w"] = _power_limit()
    out = {"correct": bool(correct), "attempted": drive.attempted,
           "failed": drive.failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    t_start = _T_IMPORT - _process_age()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]  # not the harness dir

    import torch

    from hodbench import spec
    if not torch.cuda.is_available():
        print("no CUDA device is visible: this benchmark runs on the card",
              file=sys.stderr)
        return 2
    bench = spec.load(ROOT)
    cell = spec.cell(ROOT, bench, args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    out = run_cell(ROOT, bench, cell, args.seed, args.seconds,
                   bool(args.trace), device="cuda", t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"the process loaded {bad}: the benchmark measures the port "
              "alone", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        bound = (f"<= {c['limit']}" if "limit" in c
                 else f">= {c['least']}")
        print(f"check {name} {c['value']} {bound}", file=sys.stderr)
    print(f"correct {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
