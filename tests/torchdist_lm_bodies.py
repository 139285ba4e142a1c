"""Rank-side bodies of the whole-model sharded LM tests
(``tests/test_torch_sharded_lm.py``, ``tests/test_torch_sharded_lm_serve
.py``).  This module imports the port and torch only, never JAX: every
rank imports it.  Each body returns plain Python and numpy values, which
the parent holds to the JAX package and to the port's unsharded cells.

A payload carries the JAX smoke parameters (numpy trees) and a schedule:
stages run one after another, and within a stage each mesh takes its
own ranks (the first rank of a 2-rank mesh is rank 0 or 2), so two
2-rank meshes run at once.  Every rank makes every mesh first (a
``make_mesh`` is collective over the whole group), then runs the cases
of the meshes it belongs to.  A case's whole tensors come back from the
mesh's first rank (``shardlib.gather_blocks``); every rank returns its
loss and norm, so the parent sees that the ranks agree.
"""
import dataclasses

import numpy as np
import torch

#: Prompt, cache and batch of the serve cases: gemma3's prompt stays
#: within its smoke window of 16 (``ROADMAP.md`` queue 3).
PROMPT, CACHE, SERVE_B = 16, 32, 2
#: The optimizer's count before the step: the end of the warm-up, so
#: that the update (lr 3e-4) moves every leaf past the tolerance.
COUNT0 = 2000


def params_np(arch, vocab):
    """Parameters of ``arch``'s smoke config from a numpy seed, laid out
    as the port's and the JAX package's trees: matrices normal at
    fan-in scale (the experts' on their axis 1, as ``init_params``
    draws them), norm scales normal at 0.1, so that their gradients
    show.  ``vocab`` is the JAX config's, checked against the port's."""
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    cfg = steps.lm_cell_config(arch, smoke=True)
    if cfg.vocab != vocab:
        raise ValueError(f"{arch}: vocab {cfg.vocab} against {vocab}")
    rng = np.random.default_rng(sum(map(ord, arch)))

    def draw(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    layers = []
    for _ in range(cfg.local_global_period):
        pos = {}
        for name, shp in tf._layer_shapes(cfg).items():
            fan = shp[tf._fan_in_axis(cfg, name)]
            pos[name] = draw((cfg.n_cycles,) + shp,
                             0.1 if name.startswith("ln") else fan ** -0.5)
        layers.append(pos)
    d = cfg.d_model
    out = {"embed": draw((cfg.vocab, d), d ** -0.5),
           "ln_f": draw((d,), 0.1), "layers": layers}
    if not cfg.tie_embeddings:
        out["head"] = draw((d, cfg.vocab), d ** -0.5)
    return out


def _whole(tree, shardings):
    """Every leaf of a tree of blocks gathered whole
    (``shardlib.gather_blocks``), as numpy copies (a leaf split over
    nothing comes back as itself)."""
    from repro_torch import shardlib as sl
    from repro_torch.tree import leaves
    return [sl.gather_blocks(t, s.spec).float().numpy().copy()
            for t, s in zip(leaves(tree), leaves(shardings))]


def _cfg(arch, variant, dtype):
    from repro_torch.launch import steps
    cfg = steps.lm_cell_config(arch, smoke=True)
    if variant == "opt":        # the published config's opt settings
        cfg = dataclasses.replace(cfg, attn_opt=True,
                                  remat_policy="block_outs")
    return dataclasses.replace(cfg, compute_dtype=getattr(torch, dtype))


def train_case(mesh, p, arch, variant="base", dtype="float32"):
    """One train step of ``arch``'s smoke train_4k cell, built under
    ``rules_train_lm`` on ``mesh`` and holding the JAX parameters'
    blocks (AdamW state zero at count ``COUNT0``): the loss, gnorm, the
    gradients (gathered before the clip), the updated parameters, m and
    v.  bf16 runs the cell's own step (its config); f32 the step that
    ``steps._lm_train_step`` makes at f32 compute."""
    from repro_torch import shardlib as sl
    from repro_torch.launch import steps
    from repro_torch.models.convert import (local_blocks,
                                            transformer_params_from_numpy)
    from repro_torch.optim import OptState
    from repro_torch.tree import map_tree
    cfg = _cfg(arch, variant, dtype)
    with sl.axis_rules(mesh, steps.rules_for(arch, "train_4k", mesh)):
        cell = steps.build_cell(arch, "train_4k", smoke=True, device="cpu",
                                variant=variant)
        psh = cell.in_shardings[0]["params"]
        params = local_blocks(transformer_params_from_numpy(
            p["params"][arch], cfg, device="cpu"), psh)
        zeros = lambda a: torch.zeros_like(a)   # noqa: E731
        state = {"params": params,
                 "opt": OptState(map_tree(zeros, params),
                                 map_tree(zeros, params),
                                 torch.tensor(COUNT0, dtype=torch.int32))}
        step = cell.fn if dtype == "bfloat16" else steps._lm_train_step(cfg)
        seen = {}
        inner = steps.lm_value_and_grad

        def recording(*a):
            loss, grads = inner(*a)
            seen["grads"] = _whole(grads, psh)
            return loss, grads
        steps.lm_value_and_grad = recording
        try:
            state, m = step(state, *cell.args[1:])
        finally:
            steps.lm_value_and_grad = inner
        out = {"loss": m["loss"].item(), "gnorm": m["gnorm"].item(),
               "count": int(state["opt"].count)}
        whole = {"grads": seen["grads"],
                 "params": _whole(state["params"], psh),
                 "m": _whole(state["opt"].m, psh),
                 "v": _whole(state["opt"].v, psh),
                 "tokens": sl.gather_blocks(cell.args[1],
                                            cell.in_shardings[1].spec
                                            ).numpy()}
    return out, whole


def serve_case(mesh, p, arch):
    """Prefill of the payload's prompt under ``rules_serve_lm`` on
    ``mesh`` (f32 compute, the JAX parameters' blocks), its caches laid
    into ``CACHE``-slot caches, then two decode steps of the payload's
    tokens: every logit and cache gathered whole."""
    from repro_torch import shardlib as sl
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    from repro_torch.models.convert import (local_blocks,
                                            transformer_params_from_numpy)
    cfg = _cfg(arch, "base", "float32")
    toks = torch.from_numpy(p["prompt"])
    with sl.axis_rules(mesh, steps.rules_for(arch, "decode_32k", mesh)):
        psh = steps._resolve(tf.param_shardings(cfg))
        csh = steps._resolve(tf.cache_shardings(cfg))
        params = local_blocks(transformer_params_from_numpy(
            p["params"][arch], cfg, device="cpu"), psh)
        rows = sl.logical_to_spec("batch", None)
        vocab = sl.logical_to_spec("batch", "vocab")
        logits, caches = tf.prefill(params, sl.local_block(toks, rows), cfg)
        got = {"prefill": sl.gather_blocks(logits, vocab).numpy(),
               "prefill_caches": _whole(caches, csh)}
        full = tf.make_cache(cfg, SERVE_B, CACHE, dtype=torch.float32,
                             device="cpu")
        it = iter(got["prefill_caches"])
        for pos in full:
            for name in ("k", "v"):
                part = torch.from_numpy(next(it))
                pos[name][:, :, :part.shape[2]] = part
        caches = local_blocks(full, csh)
        batch = sl.logical_to_spec("batch")
        for i, nxt in enumerate(p["next"]):
            logits, caches = tf.decode_step(
                params, caches, sl.local_block(torch.from_numpy(nxt), batch),
                PROMPT + i, cfg)
            got[f"decode{i}"] = sl.gather_blocks(logits, vocab).numpy()
        got["decode_caches"] = _whole(caches, csh)
    return got


def world1_case(mesh):
    """glm4-9b's smoke train_4k and decode_32k cells, sharded on a
    one-rank ``mesh`` and unsharded, from the same seed: the train
    step's loss, gnorm, parameters, m and v, and the decode logits and
    caches."""
    from repro_torch import shardlib as sl
    from repro_torch.launch import steps
    from repro_torch.tree import leaves
    out = {}
    for shape in ("train_4k", "decode_32k"):
        runs = []
        for ruled in (True, False):
            if ruled:
                with sl.axis_rules(mesh, steps.rules_for("glm4-9b", shape,
                                                         mesh)):
                    cell = steps.build_cell("glm4-9b", shape, smoke=True,
                                            device="cpu")
                    res = cell.run()
            else:
                cell = steps.build_cell("glm4-9b", shape, smoke=True,
                                        device="cpu")
                res = cell.run()
            if shape == "train_4k":
                state, m = res
                runs.append({"loss": m["loss"].item(),
                             "gnorm": m["gnorm"].item(),
                             "state": [t.numpy() for t in
                                       leaves((state["params"],
                                               state["opt"].m,
                                               state["opt"].v))]})
            else:
                logits, caches = res
                runs.append({"logits": logits.numpy(),
                             "caches": [t.float().numpy()
                                        for t in leaves(caches)]})
        out[shape] = runs
    return out


def lm_battery(rank, world, p):
    """The payload's schedule on this rank: ``p["stages"]`` is a list of
    stages, each a list of ``(mesh shape, ranks, cases)``; a case is
    ``("train", arch, variant, dtype)``, ``("serve", arch)`` or
    ``("world1",)``.  Returns ``{(shape, ranks, i): result}`` for the
    cases of this rank's meshes (the whole tensors on a mesh's first
    rank only)."""
    from repro_torch import shardlib as sl
    meshes = {}
    for stage in p["stages"]:
        for shape, ranks, _ in stage:
            meshes[shape, ranks] = sl.make_mesh(shape, ("data", "model"),
                                                "cpu", ranks=ranks)
    out = {}
    for stage in p["stages"]:
        for shape, ranks, cases in stage:
            mesh = meshes[shape, ranks]
            if mesh is None:
                continue
            first = rank == ranks[0]
            for i, case in enumerate(cases):
                if case[0] == "train":
                    res, whole = train_case(mesh, p, *case[1:])
                    if first:
                        res.update(whole)
                elif case[0] == "serve":
                    res = serve_case(mesh, p, case[1])
                    if not first:
                        res = None
                else:
                    res = world1_case(mesh)
                out[shape, ranks, i] = res
    return out
