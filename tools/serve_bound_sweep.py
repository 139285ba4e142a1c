#!/usr/bin/env python3
"""Read the bf16 serve checks of phases 6 and 12 and their faults over seeds.

    python3 tools/serve_bound_sweep.py [--seeds N] [--archs A,B,...]

For glm4-9b (phase 6) and each arch of ``chip_smoke.FAMILY`` (or those
named) on one GPU: for a FAMILY arch, its f32 logic check with its
controls first (``chip_smoke.family_f32_logic``, which asserts); then,
for each seed s in 0..N-1, the full-depth bf16 model with weights from a
generator seeded s and prompts from one seeded s + 1 (seed 0 is exactly
the run ``chip_smoke.py`` makes), served as phases 6 and 12 serve it
(``chip_smoke.lm_serve_run``): the 32 steps' relative L2 error against a
prefill of the extended sequences, and the steps re-run sound and with
each planted fault.  Nothing is asserted of those readings.  Per arch it
prints the largest sound reading, the smallest fault reading, their
geometric mean and the bound ``chip_smoke.py`` holds the arch to, and
whether the bound lies between them; then the card's name and power
limit, then one JSON line with every reading.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--archs", default="",
                    help="comma-separated archs (default: glm4-9b and "
                    "all of FAMILY)")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as tf

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    cs.say(card)
    _build.build(["flash_decode"])
    specs = {"glm4-9b": dict(prompt=cs.LM_PROMPT_LEN,
                             cache=cs.LM_SERVE_CACHE, rel_l2=cs.LM_REL_L2)}
    specs.update(cs.FAMILY)
    archs = args.archs.split(",") if args.archs else list(specs)
    out = {"card": card, "seeds": args.seeds, "archs": {}}
    for arch in archs:
        spec = specs[arch]
        if arch in cs.FAMILY:
            cs.family_f32_logic(torch, arch, spec)
            cs.free(torch)
        cfg = cs.no_drops(get_arch(arch).CONFIG)
        runs = []
        for seed in range(args.seeds):
            params = tf.init_params(
                cfg, torch.Generator(device="cuda").manual_seed(seed),
                "cuda", dtype=torch.bfloat16)
            gen = torch.Generator(device="cuda").manual_seed(seed + 1)
            run = cs.lm_serve_run(torch, params, cfg, gen, spec["prompt"],
                                  spec["cache"], p_bf16=False)
            rel = {"served": cs.distance(run["got"], run["want"])[0]}
            rel.update({k: r for k, (r, _) in run["controls"].items()})
            cs.say(f"{arch} seed {seed}: "
                   + "; ".join(f"{k} {v:.4e}" for k, v in rel.items()))
            runs.append(rel)
            del params, run
            cs.free(torch)
        sound = max(max(r["served"], r["sound"]) for r in runs)
        faults = {k: min(r[k] for r in runs) for k in runs[0]
                  if k not in ("served", "sound")}
        nearest = min(faults, key=faults.get)
        bound = spec["rel_l2"]
        between = sound <= bound < faults[nearest]
        cs.say(f"{arch}: largest sound reading {sound:.4e}, smallest fault "
               f"reading {faults[nearest]:.4e} ({nearest}), ratio "
               f"{faults[nearest] / sound:.3f}, geometric mean "
               f"{(sound * faults[nearest]) ** 0.5:.4e}; bound {bound:.3e} "
               + ("lies between them" if between
                  else "does NOT lie between them")
               + f" (over {args.seeds} seeds)")
        out["archs"][arch] = {"runs": runs, "max_sound": sound,
                              "min_fault": faults, "bound": bound,
                              "between": between}
    cs.say(card)
    cs.say(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
