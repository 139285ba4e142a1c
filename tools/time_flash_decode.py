#!/usr/bin/env python3
"""Check and time a tree's ``flash_decode`` at the LM family's per-layer
decode shapes.

    python3 tools/time_flash_decode.py [--tree DIR] [--only TEXT]

Imports ``repro_torch`` from ``DIR/src`` (by default this checkout's),
builds its ``flash_decode`` kernel on one GPU and prints ptxas'
registers and spills of each entry function, then runs
``chip_smoke.check_flash_decode_family`` over ``chip_smoke.FD_FAMILY``
(the rows whose name holds ``TEXT``, all by default): each row against
the plain version within atol 1e-4, the kernel's form and split plan,
its time (CUDA events, queued behind a sleep kernel) beside SDPA's and
the byte bound.  It prints the
card's name and power limit, then one JSON line.  To compare two trees,
run it for each in turns on one machine: A, B, B, A.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--only", default="",
                    help="time only the FD_FAMILY rows whose name holds this")
    args = ap.parse_args()
    src = Path(args.tree).resolve() / "src"
    if not (src / "repro_torch").is_dir():
        print(f"no src/repro_torch under {args.tree}", file=sys.stderr)
        return 2
    sys.path[:0] = [str(src), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build

    card = cs.card_line()
    cs.SM_HZ = cs.fp32_instr_per_s(torch)[1] * 1e6   # for the queued timer
    _build.build(["flash_decode"])
    ptxas = cs.ptxas_report(_build.build_log("flash_decode"))
    for fn, info in ptxas.items():
        print(f"ptxas {fn}: {info['registers']} registers, spill stores "
              f"{info['spill_stores']} B, loads {info['spill_loads']} B",
              flush=True)
    cs.FD_FAMILY = tuple(r for r in cs.FD_FAMILY if args.only in r[0])
    rows = cs.check_flash_decode_family(torch, card)
    print(card, flush=True)
    print(json.dumps({"tree": str(Path(args.tree).resolve()), "card": card,
                      "ptxas": ptxas, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
