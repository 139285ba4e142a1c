"""Each rank draws its own blocks of a cell's state (``models/init.py``,
the keyed draw), bit-equal to the cut of the state a world-1 cell draws
whole, and never holds the whole.

(a) On gloo meshes (2, 2), (1, 2) and (1, 3) (one spawn of 4 ranks,
``torchdist_block_init_bodies.gloo_battery``): every leaf of the state
of the five LM archs' smoke train_4k, prefill_32k and decode_32k cells
and of rm2's train_batch, serve_p99 and retrieval_cand cells equals the
cut of the world-1 cell's leaf, bit for bit, at the draw's tile size and
at tiles of 4 KiB (a smoke leaf then spans many tiles, and a block
meets some in part).  On (1, 3) the smoke widths are widened to
multiples of 3, which the smoke configs are not.

(b) As rank 0 and rank 255 of a "fake" group of 256 on the 16x16 mesh
(a child process), the non-abstract ``build_cell`` of the five cells
whose whole state no 80 GB card holds, run under ``FakeTensorMode`` with
``op_analysis.LiveBytes`` tracking the build: its peak of live bytes is
at most its argument bytes plus 128 MiB, the argument bytes equal
``build_cell(abstract=True)``'s, and both ranks draw as many tiles of
as many bytes (``fake_battery`` counts them: command-r-35b's rank 0
draws 284 tiles, 8.27 GB of f32, for its 0.476 GB of params).

(c) The tile grid is the leaf's alone, and at the production meshes
every tile lies inside one block or holds whole blocks; a leaf's values
do not depend on the draws before it; the laws are JAX's; the serve
checks' sequential weights are rewritten in place bit-equal to
``init_params(cfg, generator)``.

(d) The train CLI's resume and ``ElasticTrainer``'s restore draw
nothing: the tile draw patched to raise, they resume and end where an
uninterrupted run ends, bit for bit.

No JAX: the port's own world-1 cells are the reference.  Torch runs at
one thread here; the spawn and the child start before the in-process
checks.
"""
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import torchdist
from repro_torch.configs import get_arch
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps
from repro_torch.models import dlrm as td
from repro_torch.models import init
from repro_torch.models import transformer as tf
from repro_torch.tree import flatten_with_paths, leaves
from torchdist_block_init_bodies import LM, TINY_TILE, tile_bytes

ROOT = Path(__file__).resolve().parent.parent

CELLS = [(a, s) for a in LM for s in ("train_4k", "prefill_32k",
                                      "decode_32k")] + [
    ("dlrm-rm2", s) for s in ("train_batch", "serve_p99", "retrieval_cand")]
#: (mesh, the ranks on it)
MESHES = {(2, 2): range(4), (1, 2): range(2), (1, 3): range(3)}

#: The full-size cells whose whole state no card holds, with the batch
#: of each (None: the assigned one).
FULL = [("command-r-35b", "train_4k", None),
        ("qwen3-moe-30b-a3b", "train_4k", None),
        ("glm4-9b", "train_4k", None),
        ("glm4-9b", "decode_32k", 128),
        ("dlrm-rm2", "train_batch", None)]
SLACK = 128 << 20

_FAKE = """
import json, sys
sys.path.insert(0, sys.argv[2])
import torch
torch.set_num_threads(1)
from torchdist_block_init_bodies import fake_battery
json.dump(fake_battery([tuple(c) for c in json.loads(sys.argv[1])]),
          sys.stdout)
"""


@pytest.fixture(scope="module")
def background():
    """The gloo ranks of (a) and the fake-group child of (b), started
    together; the tests collect them."""
    ranks = torchdist.Ranks(4, "torchdist_block_init_bodies:gloo_battery",
                            {"cells": CELLS}, timeout=180)
    child = subprocess.Popen(
        [sys.executable, "-c", _FAKE, json.dumps(FULL),
         str(ROOT / "tests")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(ROOT), env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    try:
        yield {"ranks": ranks, "child": child}
    finally:
        ranks.close()
        if child.poll() is None:
            child.kill()
            child.communicate()


@pytest.fixture(scope="module")
def fake_reports(background):
    out, err = background["child"].communicate(timeout=240)
    assert background["child"].returncode == 0, err[-4000:]
    return {(a, s, r): tuple(rest) for a, s, r, *rest in json.loads(out)}


@pytest.fixture(autouse=True)
def _one_thread():
    with torchdist.one_thread():
        yield


# --------------------------------------------------------------------------
# (a) every rank's blocks are the cut of the world-1 cell's state


@pytest.mark.parametrize("mesh", list(MESHES), ids=str)
@pytest.mark.parametrize("arch,shape", CELLS)
def test_blocks_are_the_cut_of_the_whole(background, mesh, arch, shape):
    got = background["ranks"].results()
    for rank in MESHES[mesh]:
        for tile in (None, TINY_TILE):
            n, bad = got[rank][(mesh, tile, arch, shape)]
            assert n > 0 and not bad, (rank, tile, bad)


# --------------------------------------------------------------------------
# (b) a production-mesh build holds its blocks and one tile


@pytest.mark.parametrize("arch,shape,batch", FULL)
def test_production_mesh_build_peak(fake_reports, arch, shape, batch):
    """Each rank's build peaks within its argument bytes + 128 MiB; the
    grid lines up with the blocks, so the first and the last rank draw
    as many tiles, of as many bytes."""
    for rank in (0, 255):
        peak, args, abstract, _, _ = fake_reports[(arch, shape, rank)]
        assert args == abstract, (rank, args, abstract)
        assert args <= peak <= args + SLACK, (rank, peak, args)
    assert fake_reports[(arch, shape, 0)][3:] == \
        fake_reports[(arch, shape, 255)][3:]


# --------------------------------------------------------------------------
# (c) the grid, the key, the laws, the sequential rewrite


class _Mesh:
    """What the rules read of a mesh: its axis names and sizes."""

    def __init__(self, shape, names):
        self.shape, self.mesh_dim_names = shape, names

    def size(self, i):
        return self.shape[i]


def _splits(logical, rules, mesh):
    out = []
    for name in logical:
        axes = rules.get(name) if name else None
        axes = (axes,) if isinstance(axes, str) else (axes or ())
        out.append(math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                             for a in axes))
    return out


def _leaves_of(cfg):
    """(path, shape, logical axes) of each leaf of an LM's or rm2's
    parameters, whole."""
    if isinstance(cfg, td.DLRMConfig):
        plan = td.param_shardings(cfg)
        return [("tables", (cfg.n_sparse, cfg.vocab_per_table,
                            cfg.embed_dim), plan["tables"])]
    axes = tf.param_shardings(cfg)
    shapes = tf._layer_shapes(cfg)
    out = [("embed", (cfg.vocab, cfg.d_model), axes["embed"])]
    if not cfg.tie_embeddings:
        out.append(("head", (cfg.d_model, cfg.vocab), axes["head"]))
    for pos in range(cfg.local_global_period):
        for name, shp in shapes.items():
            out.append((f"layers/{pos}/{name}", (cfg.n_cycles,) + shp,
                        axes["layers"][pos][name]))
    return out


@pytest.mark.parametrize("arch", LM + ("dlrm-rm2",))
def test_tiles_line_up_with_the_production_blocks(arch):
    """The published configs' tiles: at most TILE_BYTES in f32, their
    extents divide the leaf's, a stack's tile one cycle; at the 16x16
    and 2x16x16 meshes, under each kind's rules, every dim's tile count
    and block count divide one another, so a block meets only tiles
    that it holds whole or that hold it whole."""
    cfg = get_arch(arch).CONFIG
    for path, shape, logical in _leaves_of(cfg):
        tile = init.tile_shape(shape, logical)
        assert 4 * math.prod(tile) <= init.TILE_BYTES, (path, tile)
        assert all(n % t == 0 for n, t in zip(shape, tile)), (path, tile)
        if logical[0] == "layer_stack":
            assert tile[0] == 1, (path, tile)
        for multi in (False, True):
            mesh = _Mesh(*tmesh.production_mesh_shape(multi))
            kinds = ([tmesh.rules_recsys(mesh, 65536)] if arch == "dlrm-rm2"
                     else [tmesh.rules_train_lm(mesh),
                           tmesh.rules_serve_lm(mesh, 128)])
            for rules in kinds:
                for n, t, k in zip(shape, tile, _splits(logical, rules,
                                                        mesh)):
                    assert (n // t) % k == 0 or k % (n // t) == 0, \
                        (path, multi, tile, k)
    if arch == "dlrm-rm2":
        assert init.tile_shape(*_leaves_of(cfg)[0][1:]) == (26, 3125, 64)


def test_a_leaf_is_its_tiles_and_no_earlier_draw():
    """A leaf drawn whole equals its tiles (each drawn alone) side by
    side, and a leaf drawn after others equals it drawn alone.  At 1 KiB
    a tile: a cycle, then 48 -> 24 (the longer named dim), 40 -> 20,
    24 -> 12, and 12 x 20 f32 fit."""
    shape, axes = (3, 48, 40), ("layer_stack", "fsdp", "heads")
    with tile_bytes(1024):
        tile = init.tile_shape(shape, axes)
        alone = init.keyed("w", shape, axes, "normal", 0.5)
        init.keyed("before", (64, 64), (None, None), "normal", 1.0)
        after = init.keyed("w", shape, axes, "normal", 0.5)
        side = torch.cat([torch.cat([torch.cat([init.draw_tile(
            "w", (c, i, j), tile, "normal", 0.5, torch.device("cpu"), 0)
            for j in range(2)], 2) for i in range(4)], 1)
            for c in range(3)], 0)
    assert tile == (1, 12, 20)
    assert torch.equal(alone, after) and torch.equal(alone, side)
    assert not torch.equal(alone, init.keyed("v", shape, axes, "normal",
                                             0.5))


def test_the_laws_are_jax():
    """Matrices normal x fan_in^-0.5 (the experts' fan-in on axis 1),
    norm scales zero; rm2's tables uniform in +-V^-0.5; MLP biases
    zero."""
    cfg = dataclasses.replace(get_arch("qwen3-moe-30b-a3b").smoke_config(),
                              d_model=128, n_layers=4)
    p = tf.init_params(cfg, device="cpu")
    stack = p["layers"][0]
    for name, fan in (("wq", cfg.d_model), ("wg", cfg.d_model),
                      ("wd", cfg.moe.d_ff), ("router", cfg.d_model)):
        std = float(stack[name].std())
        assert abs(std * fan ** 0.5 - 1) < 0.05, (name, std)
    assert not stack["ln1"].any() and not p["ln_f"].any()
    rcfg = get_arch("dlrm-rm2").smoke_config()
    r = td.init_params(rcfg, device="cpu")
    bound = rcfg.vocab_per_table ** -0.5
    assert float(r["tables"].abs().max()) <= bound
    assert float(r["tables"].abs().max()) > 0.99 * bound
    assert not any(b.any() for _, b in r["bot"] + r["top"])


def _sequential(cfg, gen, dtype):
    """The sequential law as ``init_params(cfg, generator)`` drew it
    before the keyed draw: each cycle position's matrices cycle by cycle
    through ``dense_init``, then the embedding, then the head."""
    from repro_torch.models.common import dense_init
    layers = []
    for _ in range(cfg.local_global_period):
        stack = {}
        for name, shp in tf._layer_shapes(cfg).items():
            stack[name] = (torch.zeros((cfg.n_cycles,) + shp, dtype=dtype)
                           if name.startswith("ln") else torch.stack([
                               dense_init(gen, shp, tf._fan_in_axis(cfg, name),
                                          dtype=dtype)
                               for _ in range(cfg.n_cycles)]))
        layers.append(stack)
    out = {"embed": dense_init(gen, (cfg.vocab, cfg.d_model), dtype=dtype),
           "ln_f": torch.zeros(cfg.d_model, dtype=dtype), "layers": layers}
    if not cfg.tie_embeddings:
        out["head"] = dense_init(gen, (cfg.d_model, cfg.vocab), dtype=dtype)
    return out


@pytest.mark.parametrize("arch", ("glm4-9b", "gemma3-12b",
                                  "qwen3-moe-30b-a3b"))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_sequential_rewrite_in_place(arch, dtype):
    """``draw_sequential_`` turns a cell's keyed weights into the
    sequential draw, bit for bit, in the same tensors (the serve checks'
    weights on the card), and ``init_params`` with a generator draws the
    same."""
    cfg = get_arch(arch).smoke_config()
    keyed = tf.init_params(cfg, device="cpu", dtype=dtype)
    before = [t.data_ptr() for t in leaves(keyed)]
    tf.draw_sequential_(keyed, cfg, torch.Generator().manual_seed(0))
    want = _sequential(cfg, torch.Generator().manual_seed(0), dtype)
    seq = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                         dtype=dtype)
    assert [t.data_ptr() for t in leaves(keyed)] == before
    for (k, a), b, c in zip(flatten_with_paths(keyed), leaves(want),
                            leaves(seq)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
        assert torch.equal(c, b), k


# --------------------------------------------------------------------------
# (d) a resume draws nothing


def _refuse(*args, **kwargs):
    raise AssertionError("the resume drew a tile")


@pytest.mark.parametrize("arch", ("glm4-9b", "dlrm-rm2"))
def test_cli_resume_draws_nothing(tmp_path, monkeypatch, arch):
    """Run A trains 3 steps (checkpoints at steps 0-2); run B resumes
    from a copy of A's step 0 with the tile draw refused, and its step 2
    equals A's, leaf for leaf."""
    from repro_torch.checkpoint import load_pytree
    from repro_torch.launch import train
    shape = "train_4k" if arch in LM else "train_batch"
    argv = ["--arch", arch, "--shape", shape, "--smoke", "--steps", "3",
            "--ckpt-every", "1", "--device", "cpu"]
    a, b = tmp_path / "a", tmp_path / "b"
    train.main(argv + ["--ckpt-dir", str(a)])
    b.mkdir()
    shutil.copytree(a / "step_00000000", b / "step_00000000")
    monkeypatch.setattr(init, "draw_tile", _refuse)
    out = train.main(argv + ["--ckpt-dir", str(b)])
    assert out["step"] == 2
    cell = steps.build_cell(arch, shape, smoke=True, device="cpu",
                            draw=False)
    want, _ = load_pytree(str(a / "step_00000002"), cell.args[0])
    got, _ = load_pytree(str(b / "step_00000002"), cell.args[0])
    for (k, x), y in zip(flatten_with_paths(got), leaves(want)):
        assert torch.equal(x, y), k


def test_elastic_restore_draws_nothing(tmp_path, monkeypatch):
    """``ElasticTrainer`` on rm2's smoke cell, a failure before step 3
    (checkpoints every 2): the restart restores step 1 with the tile
    draw refused and ends equal to an uninterrupted run."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.ft import ElasticTrainer
    from repro_torch.optim import OptState
    from repro_torch.tree import map_tree

    def cell_of(draw):
        return steps.build_cell("dlrm-rm2", "train_batch", smoke=True,
                                device="cpu", draw=draw)
    cell = cell_of(True)

    def step_fn(state, step):
        return cell.fn(state, *cell.batch_at(step))[0]
    whole = map_tree(lambda t: t.clone(), cell.args[0])
    for step in range(4):
        whole = step_fn(whole, step)

    def build(n_devices, restored):
        if restored is None:
            return cell_of(True).args[0], step_fn
        return {"params": restored["params"],
                "opt": OptState(**restored["opt"])}, step_fn

    def injector(step):
        if step == 3 and not failed:
            failed.append(step)
            monkeypatch.setattr(init, "draw_tile", _refuse)
            raise RuntimeError("injected")
    failed = []
    state, log = ElasticTrainer(
        ckpt=CheckpointManager(str(tmp_path), keep_last=2), build=build,
        total_steps=4, ckpt_every=2, failure_injector=injector).run(1)
    assert log["restarts"] == 1 and log["resumed_from"] == [1]
    for (k, x), y in zip(flatten_with_paths(state), leaves(whole)):
        assert torch.equal(x, y), k
