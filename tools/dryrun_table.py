#!/usr/bin/env python3
"""Print the dry run's reports as a markdown table, one row a cell and
mesh, for ``PERF.md``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    python3 tools/dryrun_table.py [--dir reports/dryrun_torch]

Each row: ok, fits, argument and temp GB a card, the dominant roofline
term and its three seconds, ``useful_ratio`` (model FLOPs over the
cards' counted FLOPs), ``matmul`` (model FLOPs over the cards' product
FLOPs alone), ``embed`` (for an LM train cell, the share of its model
FLOPs that 6·N gives the embedding table, whose lookups multiply
nothing) and the kernels' launches a step.  A failed cell's row carries
the first line of its error.  Every figure is a prediction of the dry
run (fake tensors, data-sheet constants); none is a measurement.
"""
import argparse
import glob
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _embed_share(rep) -> str:
    """6 x vocab x d_model x tokens over the cell's model FLOPs."""
    if rep.get("kind") != "train" or rep["arch"] in (
            "schnet", "gin-tu", "equiformer-v2", "gcn-cora", "dlrm-rm2"):
        return ""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_arch
    from repro_torch.configs.shapes import LM_SHAPES
    cfg = get_arch(rep["arch"]).CONFIG
    sp = LM_SHAPES[rep["shape"]]
    toks = sp["global_batch"] * sp["seq_len"]
    return f"{6 * cfg.vocab * cfg.d_model * toks / rep['model_flops']:.3f}"


def row(rep) -> str:
    head = f"| {rep['arch']} | {rep['shape']} | {rep['mesh']} "
    if not rep["ok"]:
        return head + f"| no: {rep['error'].splitlines()[0][:80]} |" \
            + " |" * 10
    pd, rf = rep["per_device"], rep["roofline"]
    chips = rep["chips"]
    launches = ", ".join(f"{k} {v['launches']}"
                         for k, v in sorted(rep["kernels"].items())) or "0"
    return (head + f"| yes | {'yes' if rep['fits'] else 'no'} "
            f"| {pd['argument_bytes'] / 1e9:.3f} "
            f"| {pd['temp_bytes'] / 1e9:.3f} | {rf['dominant']} "
            f"| {rf['compute_s']:.4g} | {rf['memory_s']:.4g} "
            f"| {rf['collective_s']:.4g} | {rep['useful_ratio']:.3f} "
            f"| {rep['model_flops'] / max(pd['matmul_flops'] * chips, 1):.3f} "
            f"| {_embed_share(rep)} | {launches} |")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=os.path.join(ROOT, "reports",
                                                   "dryrun_torch"))
    args = ap.parse_args()
    reports = [json.load(open(p)) for p in
               sorted(glob.glob(os.path.join(args.dir, "*.json")))]
    order = {"single": 0, "multi": 1}
    reports.sort(key=lambda r: (r["arch"], r["shape"], order[r["mesh"]]))
    print("| Arch | Shape | Mesh | ok | fits | arg GB | temp GB | dominant "
          "| compute s | memory s | collective s | useful | matmul | embed "
          "| launches |")
    print("| --- " * 15 + "|")
    for rep in reports:
        print(row(rep))
    ok = [r for r in reports if r["ok"]]
    dominant = {k: sum(r["roofline"]["dominant"] == k for r in ok)
                for k in ("compute", "memory", "collective")}
    print(f"\n{len(reports)} reports, {len(ok)} ok, "
          f"{sum(r['fits'] for r in ok)} fit; dominant {dominant}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
