"""Sharded checkpoints of the port against its unsharded saves and the
JAX package's loader.

glm4-9b's, gcn-cora's and dlrm-rm2's smoke train cells, built under
their rules on gloo meshes (1, 4) and (2, 2) and stepped once (so m, v
and the count are nonzero), are saved by blocks: the state through
``CheckpointManager.save(..., shardings=cell.in_shardings[0])`` (async),
its parameters cast to bf16 through ``save_pytree(..., shardings=)``.
Each rank writes its own blocks of the whole leaves (glm4's FSDP rows
over ``data`` and heads' columns over ``model``, rm2's table rows, the
GNN's replicated leaves by one rank).  The checks:

* each directory is byte-equal to the port's unsharded ``save_pytree``
  of the gathered tree (``gather_blocks``): every ``.npy`` and the
  manifest, whole-leaf CRCs included;
* the JAX package's ``load_pytree`` reads each back equal to the
  gathered tree (the bf16 leaves, which it reads as 2-byte void, as
  bits, as in ``tests/test_torch_checkpoint.py``);
* restores onto the same mesh and onto another ((1, 4) -> (1, 2),
  (2, 2) -> (1, 4)) give each rank ``local_block`` of the whole leaf,
  bit for bit, dtype and shape included, at the step saved;
* one flipped byte in one leaf (one whose CRC another rank checks than
  the one that flips it) makes every rank's restore raise ``IOError``
  naming it;
* a save whose writes fail on one rank raises on every rank, and leaves
  the step before it the latest, with no ``.tmp`` left behind;
* a 32 MiB leaf cut by columns over 4 ranks restores with
  ``tracemalloc``'s peak below half the leaf on every rank (each reads
  its block, and the CRC of its share in 4 MiB chunks).

One spawn of 4 ranks runs every mesh, started with the module.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from repro.checkpoint import load_pytree as jload
from repro_torch.checkpoint import CheckpointManager
from repro_torch.tree import flatten_with_paths, map_tree
import torchdist
import torchdist_ckpt_bodies as bodies

ARCHS = tuple(bodies.CELLS)
R4 = (0, 1, 2, 3)
SAVED = {(1, 4): "m14", (2, 2): "m22"}


def _dirs(root, mesh, arch):
    base = os.path.join(root, f"{SAVED[mesh]}_{arch}")
    return {k: os.path.join(base, k) for k in
            ("sharded", "whole", "bf16", "whole_bf16", "corrupt", "crash")}


def _stages(root):
    """(mesh, ranks, cases) in the order the ranks run them."""
    d14 = {a: _dirs(root, (1, 4), a) for a in ARCHS}
    d22 = {a: _dirs(root, (2, 2), a) for a in ARCHS}
    big = {"big": os.path.join(root, "big")}
    return [
        ((1, 4), R4, [("save", a, d14[a]) for a in ARCHS]),
        ((2, 2), R4, [("save", a, d22[a]) for a in ARCHS]
         + [("restore", a, d22[a]) for a in ARCHS]
         + [("crash", "dlrm-rm2", d22["dlrm-rm2"])]),
        ((1, 4), R4, [("restore", a, d14[a]) for a in ARCHS]
         + [("restore", a, d22[a]) for a in ARCHS]
         + [("corrupt", "glm4-9b", d14["glm4-9b"]), ("memory", None, big)]),
        ((1, 2), (0, 1), [("restore", a, d14[a]) for a in ARCHS]),
    ]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("sharded_ckpt"))


@pytest.fixture(scope="module")
def results(root):
    ranks = torchdist.Ranks(4, "torchdist_ckpt_bodies:ckpt_battery",
                            {"stages": _stages(root)}, timeout=300.0)
    try:
        yield ranks.results()
    finally:
        ranks.close()


def _find(root, results, kind, arch, mesh, src=None):
    """Every rank's result of the first case of ``kind`` on ``mesh``
    (``src``: the mesh its directory was saved on)."""
    want = None if src is None else _dirs(root, src, arch)
    for j, (shape, ranks, cases) in enumerate(_stages(root)):
        for i, (k, a, d) in enumerate(cases):
            if (k, a, shape) == (kind, arch, mesh) and (want is None
                                                         or d == want):
                return [results[r][j, i] for r in ranks]
    raise KeyError((kind, arch, mesh, src))


def _files(path):
    return sorted(os.listdir(path))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_save_is_the_whole_save(root, results, mesh, arch):
    d = _dirs(root, mesh, arch)
    for got, want in ((os.path.join(d["sharded"], "step_00000001"),
                       d["whole"]), (d["bf16"], d["whole_bf16"])):
        assert _files(got) == _files(want)
        assert len(_files(got)) > 2
        for name in _files(got):
            a = open(os.path.join(got, name), "rb").read()
            b = open(os.path.join(want, name), "rb").read()
            if name == "manifest.json":
                assert json.loads(a) == json.loads(b)
            assert a == b, name
    assert os.listdir(d["sharded"]) == ["step_00000001"]


def _like(path):
    """A tree of zeros shaped as the manifest's leaves (the JAX loader's
    template), without the bf16 leaves."""
    tree, _ = CheckpointManager(os.path.dirname(path)).peek(
        int(os.path.basename(path)[5:]))
    return map_tree(lambda s: jnp.zeros(s.shape, s.dtype), tree)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_jax_loader_reads_a_sharded_save(root, results, mesh, arch):
    d = _dirs(root, mesh, arch)
    step = os.path.join(d["sharded"], "step_00000001")
    got, extra = jload(step, _like(step))
    assert extra == {"step": 1}
    n = 0
    for key, a in _flat_jax(got):
        want = np.load(os.path.join(d["whole"], key.replace("/", "__")
                                    + ".npy"))
        assert a.dtype == want.dtype
        np.testing.assert_array_equal(a, want, err_msg=key)
        n += 1
    with open(os.path.join(step, "manifest.json")) as f:
        assert n == len(json.load(f)["leaves"])
    # the bf16 leaves as bits: each package's loader reads them as the
    # 2-byte void numpy saves
    for name in _files(d["bf16"]):
        if name.endswith(".npy"):
            a = np.load(os.path.join(d["bf16"], name))
            assert a.dtype == np.dtype("V2")
            np.testing.assert_array_equal(
                a.view(np.uint16),
                np.load(os.path.join(d["whole_bf16"], name)).view(np.uint16))


def _flat_jax(tree):
    return [(k, np.asarray(a)) for k, a in flatten_with_paths(tree)]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh,src", [((1, 4), (1, 4)), ((2, 2), (2, 2)),
                                      ((1, 2), (1, 4)), ((1, 4), (2, 2))],
                         ids=["1x4-from-1x4", "2x2-from-2x2",
                              "1x2-from-1x4", "1x4-from-2x2"])
def test_restore_gives_each_rank_its_block(root, results, mesh, src, arch):
    got = _find(root, results, "restore", arch, mesh, src)
    assert len(got) == mesh[0] * mesh[1]
    for r in got:
        assert r["differ"] == [] and r["step"] == 1
        assert r["n"] > 2


def test_a_flipped_byte_raises_on_every_rank(root, results):
    got = _find(root, results, "corrupt", "glm4-9b", (1, 4))
    assert len(got) == 4
    key = got[0][0]
    for flipped, err in got:
        assert flipped == key
        assert err is not None and "checksum mismatch" in err and key in err


def test_a_failed_write_leaves_the_last_step(root, results):
    got = _find(root, results, "crash", "dlrm-rm2", (2, 2))
    assert len(got) == 4
    for i, r in enumerate(got):
        assert r["latest"] == 1
        assert r["left"] == ["step_00000001"]
        if i == 1:
            assert r["raised"] == "OSError: injected write failure"
        else:
            assert r["raised"].startswith("OSError: checkpoint ")
            assert "a write failed on another rank" in r["raised"]


def test_restore_holds_no_whole_leaf(root, results):
    got = _find(root, results, "memory", None, (1, 4))
    for r in got:
        assert r["equal"]
        assert r["bytes"] >= 32 * 2 ** 20
        assert r["peak"] < r["bytes"] / 2, r

