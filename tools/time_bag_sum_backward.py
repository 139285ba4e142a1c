#!/usr/bin/env python3
"""Check and time a tree's ``bag_sum_backward`` at dlrm-rm2's train_batch
shape.

    python3 tools/time_bag_sum_backward.py [--tree DIR] [--seed N]

Imports ``repro_torch`` from ``DIR/src`` (by default this checkout's),
builds its ``embedding_bag`` kernels on one GPU and prints ptxas'
registers and spills of the backward's entry functions.  The inputs are
train_batch's: ``RecsysStream``'s first batch (B 65,536, 26 fields of
Zipf(1.2) ids) offset by field into the [26e6, 64] f32 table, as
``models/dlrm.py``'s lookup sends them (ids [1703936, 1], mask ones),
and a seeded ``grad_out`` [1703936, 64] f32 (N(0, 1) x 1e-5, a mean
loss's scale).  The call is held against ``bag_sum_backward_ref`` by
``chip_smoke.check_bwd_output`` (at the tree's runs-pass chunk), and
where the tree has a radix sort (``plan_backward``), its rows and slots
against ``backward_plan``'s.  Then the call (CUDA events, queued behind
a sleep kernel), the plain version, ``index_add_`` and the parts the
tree has (the radix sort, the runs and carry passes; ``torch.sort``'s
``backward_plan`` and the dense zero fill in every tree) are timed, and
the byte bound computed.  It prints the card's name and power limit,
then one JSON line.  To compare two trees, run it for each in turns on
one machine: A, B, B, A.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
N_FIELDS, VOCAB, DIM, BATCH = 26, 1_000_000, 64, 65536


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--seed", type=int, default=0,
                    help="grad_out's generator seed")
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
    from repro_torch.data.recsys import RecsysStream
    from repro_torch.kernels import _build
    from repro_torch.kernels.embedding_bag import backward_plan
    from repro_torch.kernels.embedding_bag import ops
    from repro_torch.launch.steps import SEED

    card = cs.card_line()
    cs.FP32_INSTR_PER_S, mhz = cs.fp32_instr_per_s(torch)
    cs.SM_HZ = mhz * 1e6                 # for the queued timer
    _build.build(["embedding_bag"])
    ptxas = {fn: i for fn, i in cs.ptxas_report(
        _build.build_log("embedding_bag")).items() if "bag_bwd" in fn}
    for fn, info in ptxas.items():
        print(f"ptxas {fn}: {info['registers']} registers, spill stores "
              f"{info['spill_stores']} B, loads {info['spill_loads']} B",
              flush=True)

    _, sparse, _ = RecsysStream(batch=BATCH, n_sparse=N_FIELDS, vocab=VOCAB,
                                seed=SEED).batch_at(0)
    flat = torch.from_numpy(sparse).long() + torch.arange(N_FIELDS) * VOCAB
    ids = flat.to(torch.int32).view(-1, 1).cuda()
    n, n_rows = ids.numel(), N_FIELDS * VOCAB
    mask = torch.ones((n, 1), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    g = torch.randn((n, DIM), generator=gen, device="cuda") * 1e-5

    planned = hasattr(ops, "plan_backward")
    chunk = ops.plan_backward(n, n_rows).chunk if planned else ops.BWD_CHUNK
    got = ops.bag_sum_backward(g, ids, mask, n_rows)
    chk = cs.check_bwd_output(torch, got, g, ids, mask, n_rows, chunk)
    if not torch.equal(ops.bag_sum_backward(g, ids, mask, n_rows), got):
        raise AssertionError("bag_sum_backward gave other bits at its "
                             "second launch")
    del got
    cs.free(torch)
    buf = torch.zeros((n_rows, DIM), device="cuda")
    row = cs.bwd_call_times(torch, g, ids, mask, n_rows, buf,
                            chk["touched"])
    if planned:
        cs.check_bwd_index(torch, ids, n_rows)
        row["parts"] = cs.bwd_parts(torch, g, ids, mask, n_rows, buf)
        row["plan"] = cs.bwd_plan_text(n, n_rows)
    else:
        row["parts"] = {
            "torch_sort_ms": cs.time_ms(
                torch, lambda: backward_plan(ids, n_rows), iters=20),
            "memset_ms": cs.time_ms(torch, buf.zero_, iters=10)}
    row.update(chunk=chunk, max_abs_err=chk["max_abs_err"],
               touched=chk["touched"], hottest=chk["hottest"],
               caught=chk["caught"])
    print(f"bag_sum_backward: {row['ms']:.4f} ms a call, bound "
          f"{row['bound_ms']:.4f} ms, index_add_ {row['library_ms']:.4f} "
          f"ms, parts {row['parts']}", flush=True)
    print(card, flush=True)
    print(json.dumps({"tree": str(Path(args.tree).resolve()), "card": card,
                      "ptxas": ptxas, "row": row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
