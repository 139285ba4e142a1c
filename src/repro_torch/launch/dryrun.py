"""Dry run of the port: every (arch x shape x mesh) cell traced on fake
tensors, without a card (the counterpart of ``src/repro/launch/dryrun.py``,
which lowers and compiles each cell for 512 fake TPU devices).

For each cell this shows, for rank 0 of the 16x16 single-pod or the
2x16x16 multi-pod mesh of ``launch/mesh.py::production_mesh_shape``:

* that the cell builds under its axis rules and its step runs there:
  ``build_cell(..., abstract=True)`` on a ``"fake"`` process group of 256
  or 512 ranks (this process is rank 0; every collective returns at
  once), its step run once under ``FakeTensorMode``;
* each card's work in that step (:mod:`.op_analysis`): FLOPs by dtype,
  the bytes of eager's ops (every op its own kernel, no fusion, so more
  than a fused program moves), the bytes it sends by collective kind,
  and each hand-written kernel's calls, operations and bytes (their
  fake forms);
* whether it fits: the argument, output and temp bytes at the step's
  peak of live storage, against the card's memory;
* a roofline from the H100's data sheet (:data:`CARD`): compute, memory
  and collective seconds, which dominates, and ``useful_ratio``, the
  cell's model FLOPs over the cards' counted FLOPs.

A report has the JAX report's keys; ``lower_s``/``compile_s`` become
``build_s``/``trace_s``, and ``xla_body_once_flops`` and ``code_bytes``
are null (there is no compiled program).  It adds ``card``, ``fits``,
``kernels``, the rank and the mesh's shape.  Reports go to
``reports/dryrun_torch/``, one JSON file a cell, so the sweep resumes:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b \\
        --shape train_4k --mesh single          # one cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--jobs 4]

Every figure is a prediction from shapes and data-sheet constants; none
is a measurement on a card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
import traceback
from typing import Dict, Optional, Sequence

import torch.distributed as dist

# The card the roofline is drawn for: one H100 SXM.  Peaks from NVIDIA's
# data sheet (dense, at the 700 W limit); the memory as the card reports it.
CARD = {
    "name": "NVIDIA H100 80GB HBM3",
    "memory_bytes": 85_017_493_504,
    "memory_source": "torch.cuda.get_device_properties(0).total_memory on "
                     "an NVIDIA H100 80GB HBM3, 700.00 W",
    "bf16_flops_per_s": 989e12,
    "bf16_source": "H100 SXM data sheet: dense bf16 on the tensor cores",
    "f32_flops_per_s": 67e12,
    "f32_source": "H100 SXM data sheet: fp32 outside the tensor cores (the "
                  "port enables no TF32); every dtype but bf16 and f16",
    "hbm_bytes_per_s": 3.35e12,
    "hbm_source": "H100 SXM data sheet: HBM3",
    "net_bytes_per_s": 50e9,
    "net_source": "one 400 Gb/s NIC a card: every group of the 16x16 and "
                  "2x16x16 meshes spans more cards than an 8-card node holds",
}

REPORT_DIR = "reports/dryrun_torch"


def _peak(dtype: str) -> float:
    return (CARD["bf16_flops_per_s"] if dtype in ("bfloat16", "float16")
            else CARD["f32_flops_per_s"])


def _mesh_of(mesh_kind: str, mesh_shape: Optional[Sequence[int]]):
    """(shape, axis names) of the mesh a cell runs on: the production
    mesh, or ``mesh_shape`` over its last axes (``()``: no mesh)."""
    from .mesh import production_mesh_shape
    full, names = production_mesh_shape(multi_pod=(mesh_kind == "multi"))
    if mesh_shape is None:
        return full, names
    shape = tuple(int(n) for n in mesh_shape)
    if len(shape) > len(names):
        raise ValueError(f"mesh_shape {shape}: at most {len(names)} axes "
                         f"{names}")
    return shape, names[len(names) - len(shape):]


@contextlib.contextmanager
def fake_mesh(shape: Sequence[int], names: Sequence[str], rank: int = 0):
    """The mesh ``shape`` over ``names`` (cuda), on a ``"fake"`` default
    process group of as many ranks, in which this process is ``rank`` and
    every collective returns at once; the group is destroyed after the
    ``with`` block.  None may be live before it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from .. import shardlib as sl
    if dist.is_initialized():
        raise RuntimeError("a fake group is process-wide; one is live in "
                           "this process")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=math.prod(shape))
    try:
        yield sl.make_mesh(shape, names, "cuda")
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, shape: str, mesh_kind: str = "single",
             variant: str = "base", mesh_shape: Optional[Sequence[int]] = None,
             layers: Optional[int] = None, batch: Optional[int] = None,
             smoke: bool = False) -> Dict:
    """Trace one step of the cell on fake tensors and report rank 0's
    figures (the module's docstring).  ``mesh_shape`` replaces the
    production mesh (``()``: the unsharded cell on one card, no group);
    ``layers``, ``batch`` and ``smoke`` cut the cell as ``build_cell``
    does.  It starts and ends its own fake process group, so none may
    be live."""
    from .. import shardlib as sl
    from ..device import fake_device
    from .op_analysis import LiveBytes, OpAnalysis
    from .steps import build_cell, rules_for

    shape_m, names = _mesh_of(mesh_kind, mesh_shape)
    n_chips = math.prod(shape_m)
    t0 = time.time()
    with contextlib.ExitStack() as stack:
        if shape_m:
            mesh = stack.enter_context(fake_mesh(shape_m, names))
            stack.enter_context(sl.axis_rules(mesh, rules_for(arch, shape,
                                                              mesh)))
        cell = build_cell(arch, shape, smoke=smoke, variant=variant,
                          layers=layers, batch=batch, abstract=True)
        t_build = time.time() - t0
        with cell.meta["fake_mode"], OpAnalysis() as oa, \
                LiveBytes(cell.args) as live:
            mem = live.finish(cell.run())
    t_trace = time.time() - t0 - t_build
    acc = oa.report()
    terms = {
        "compute_s": sum(f / _peak(d) for d, f in acc["flops_by_dtype"].items()),
        "memory_s": acc["bytes"] / CARD["hbm_bytes_per_s"],
        "collective_s": acc["collective_bytes"] / CARD["net_bytes_per_s"],
    }
    dominant = max(terms, key=terms.get)
    held = mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
    report = {
        "arch": arch, "shape": shape, "mesh": mesh_kind, "chips": n_chips,
        "mesh_shape": list(shape_m), "mesh_axes": list(names[:len(shape_m)]),
        "rank": 0, "ok": True, "variant": variant, "kind": cell.kind,
        "reduced": cell.meta.get("reduced"),
        "fake_device": str(fake_device()),
        "build_s": round(t_build, 1), "trace_s": round(t_trace, 1),
        "per_device": {
            "hlo_flops": acc["flops"],
            "hlo_bytes": acc["bytes"],
            "xla_body_once_flops": None,
            "matmul_flops": acc["matmul_flops"],
            "flops_by_dtype": acc["flops_by_dtype"],
            "collective_bytes": acc["collective_bytes"],
            "collectives": acc["collectives"],
            "bytes_by_class": acc["bytes_by_class"],
            **mem,
            "code_bytes": None,
        },
        "kernels": acc["kernels"],
        "fits": held <= CARD["memory_bytes"],
        "card": CARD,
        "roofline": {**terms, "dominant": dominant.replace("_s", "")},
        "model_flops": float(cell.model_flops),
        "useful_ratio": (float(cell.model_flops)
                         / max(acc["flops"] * n_chips, 1.0)),
    }
    return report


def cell_path(arch: str, shape: str, mesh_kind: str,
              variant: str = "base") -> str:
    suffix = "" if variant == "base" else f"__{variant}"
    return os.path.join(REPORT_DIR,
                        f"{arch}__{shape}__{mesh_kind}{suffix}.json")


def _failure(arch, shape, mesh_kind, variant, error, tb) -> Dict:
    return {"arch": arch, "shape": shape, "mesh": mesh_kind, "ok": False,
            "variant": variant, "error": error, "traceback": tb}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--variant", choices=["base", "opt"], default="base")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--meshes", default="single,multi")
    args = ap.parse_args(argv)
    os.makedirs(REPORT_DIR, exist_ok=True)

    if not args.all:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape name a cell (or pass --all)")
        path = cell_path(args.arch, args.shape, args.mesh, args.variant)
        if os.path.exists(path) and not args.force:
            print(f"cached: {path}")
            return 0
        try:
            rep = run_cell(args.arch, args.shape, args.mesh, args.variant)
        except Exception as e:  # a cell that fails is a fault of the port
            rep = _failure(args.arch, args.shape, args.mesh, args.variant,
                           repr(e), traceback.format_exc())
        with open(path, "w") as f:
            json.dump(rep, f, indent=1)
        print(json.dumps({k: v for k, v in rep.items()
                          if k not in ("traceback", "card")}, indent=1))
        return 0 if rep.get("ok") else 1

    # --all: one subprocess a cell (a process holds one default group)
    from ..configs import all_cells
    cells, skipped = all_cells()
    for a, s, why in skipped:
        print(f"SKIP {a} × {s}: {why}")
    jobs = [(a, s, mk) for mk in args.meshes.split(",") for a, s in cells
            if args.force or not os.path.exists(
                cell_path(a, s, mk, args.variant))]
    print(f"{len(jobs)} cells to trace", flush=True)
    running, fails, t0 = [], 0, time.time()
    while jobs or running:
        while jobs and len(running) < args.jobs:
            a, s, mk = jobs.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", a, "--shape", s, "--mesh", mk,
                   "--variant", args.variant, "--force"]
            running.append(((a, s, mk), subprocess.Popen(
                cmd, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)))
        time.sleep(0.5)
        for (a, s, mk), pr in [r for r in running if r[1].poll() is not None]:
            running.remove(((a, s, mk), pr))
            path = cell_path(a, s, mk, args.variant)
            if not os.path.exists(path):   # the child died before writing
                with open(path, "w") as f:
                    json.dump(_failure(a, s, mk, args.variant,
                                       f"exit code {pr.returncode}", None),
                              f, indent=1)
            ok = pr.returncode == 0
            fails += 0 if ok else 1
            print(f"{'OK  ' if ok else 'FAIL'} {a} × {s} × {mk}", flush=True)
    print(f"done in {time.time() - t0:.1f} s; {fails} failures")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
