"""The port's train CLI on a mesh of gloo ranks against the JAX package.

For glm4-9b, gcn-cora and dlrm-rm2 (smoke), the JAX smoke cell's state
is saved by the JAX ``CheckpointManager`` as step 0 (the two packages'
trees have the same keys and leaves, checked here, so nothing passes
through ``models/convert.py``; glm4's count is set to 2,000, the end of
its schedule's warm-up, so that lr is 3e-4 and the updates show).  The
port's ``launch.train.main([... "--device", "cpu"])`` then runs on 4
and on 2 ranks, each ``(1, world)`` smoke mesh (torchrun's world is the
live group here): it resumes from the JAX checkpoint by blocks and
trains steps 1-3, checkpointing by blocks at steps 1 and 3.  Its step 3,
read by the JAX package's ``load_pytree``, is held to JAX's smoke cell
stepped three times from the same state over the same batches (the
port's stream's batches 1-3; the GNN's one graph), JAX unsharded: its
mesh path fails under the installed jax (ROADMAP.md queue 3).

Also on 4 ranks: a run cut after step 2 (``--steps 3``) and resumed on
the same world from a copy of its checkpoint ends in a step 3 directory
byte-equal to the uninterrupted run's; resumed on 2 ranks it stays in
the bounds below.  And ``ElasticTrainer`` with ``shardings`` on
gcn-cora: 6 steps on ``surviving_mesh(4)``, checkpoints every 2, a
``DeviceLoss(2)`` before step 3: the mesh is re-cut onto
``surviving_mesh(2)``, the state restored onto it by blocks from step
1, ranks 2 and 3 get ``None``, and the final parameters are the port's
unsharded cell's after 6 steps within the GNN bounds.

Bounds, from ``tests/test_torch_sharded_{recsys,gnn,lm}.py``:

* dlrm-rm2: the last loss and gnorm rtol 1e-5; m and v rtol 1e-5 with
  an atol of 1e-5 of the leaf's largest magnitude; the parameters atol
  1e-5, except at most 2 elements (or 1e-4 of a leaf) whose RMS
  gradient fell below 1e-7, within 2 lr a step.
* gcn-cora: the last loss and gnorm rtol 1e-5; m and v as rm2's; the
  update ``p - p0`` rtol 1e-4 with an atol of 1e-4 of the leaf's
  largest update, except elements whose RMS gradient fell below 1e-3
  of the leaf's largest (at most 2, or 1e-4 of the leaf), within 2 lr
  a step.
* glm4-9b computes in bf16 on both sides (its smoke config): the last
  loss rtol 1e-3 and gnorm rtol 2e-2 (the bf16 bounds); m, a weighted
  sum of the steps' clipped gradients, within the gradients' relative
  L2 bound 2e-2 a leaf, and v, a sum of their squares, within twice it;
  the parameters within 2 lr a step of JAX's (a bf16 gradient near 0
  may flip Adam's step).

Both spawns start with the module, before the JAX cells are built:
their runs wait for the JAX checkpoints (and the 2-rank resumes for the
4-rank cut runs), and the JAX references are computed while they run.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint import load_pytree as jload
from repro.checkpoint.manager import _flatten_with_paths as jflat
from repro.launch import steps as jsteps
from repro_torch.launch import steps as tsteps
from repro_torch.tree import flatten_with_paths
import torchdist
import torchdist_ckpt_bodies as bodies
from test_torch_sharded_lm import compiled

ARCHS = tuple(bodies.CELLS)
STEPS = 4                          # steps 1-3 after the JAX state
COUNT0 = {"glm4-9b": 2000}
LR = {"glm4-9b": 3e-4, "gcn-cora": 1e-3, "dlrm-rm2": 1e-3}
REL_L2 = 2e-2
ELASTIC = {"steps": 6, "every": 2, "fail": 3, "survivors": 2}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with torchdist.one_thread():
        yield


@functools.lru_cache(maxsize=None)
def _jax_cell(arch):
    jc = jsteps.build_cell(arch, bodies.CELLS[arch], smoke=True)
    state = jc.args[0]
    if arch in COUNT0:
        state = dict(state, opt=state["opt"]._replace(
            count=jnp.asarray(COUNT0[arch], jnp.int32)))
    return jc, state


def _argv(arch, d, steps):
    return ["--arch", arch, "--smoke", "--device", "cpu", "--ckpt-dir", d,
            "--steps", str(steps), "--ckpt-every", "2", "--log-every", "1"]


def _dir(root, name, arch):
    return os.path.join(root, f"{name}_{arch}")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("train_mesh"))


@pytest.fixture(scope="module")
def spawned(root):
    """Both spawns, started with the module: 4 ranks (the elastic case
    first), and 2 ranks.  Their runs wait for the directories they copy:
    the JAX checkpoints, which the parent writes next, and the 4-rank
    cut runs' step 2."""
    ready = {}
    four, two = [], []
    for a in ARCHS:
        jax0, cut = _dir(root, "jax0", a), _dir(root, "cut", a)
        ready.update({jax0: "step_00000000", cut: "step_00000002"})
        four += [(("full", a), _argv(a, _dir(root, "w4", a), STEPS), jax0),
                 (("cut", a), _argv(a, cut, STEPS - 1), jax0),
                 (("resume", a), _argv(a, _dir(root, "resume", a), STEPS),
                  cut)]
        two += [(("full", a), _argv(a, _dir(root, "w2", a), STEPS), jax0),
                (("half", a), _argv(a, _dir(root, "half", a), STEPS), cut)]
    ranks = [torchdist.Ranks(4, "torchdist_ckpt_bodies:cli_runs", {
        "runs": four, "ready": ready, "elastic": dict(
            ELASTIC, dir=os.path.join(root, "elastic"))}, timeout=300.0),
        torchdist.Ranks(2, "torchdist_ckpt_bodies:cli_runs",
                        {"runs": two, "ready": ready}, timeout=300.0)]
    yield ranks
    for r in ranks:
        r.close()


@pytest.fixture(scope="module")
def results(root, spawned):
    """The JAX smoke cells' states saved as step 0 by the JAX manager
    (the ranks wait for them), the references, then both spawns'
    results."""
    for arch in ARCHS:
        JManager(_dir(root, "jax0", arch), async_write=False).save(
            0, _jax_cell(arch)[1])
    for arch in ARCHS:
        jax_reference(arch)
    unsharded_elastic()
    return {4: spawned[0].results(), 2: spawned[1].results()}


@functools.lru_cache(maxsize=None)
def jax_reference(arch):
    """JAX's smoke cell stepped over steps 1-3 from the saved state:
    the last loss and gnorm, the state's leaves by key, each element's
    least RMS gradient (sqrt of the bias-corrected v) over the steps."""
    jc, state = _jax_cell(arch)
    if jc.family == "gnn":
        batches = [jc.args[1:]] * (STEPS - 1)
    else:
        tc = tsteps.build_cell(arch, bodies.CELLS[arch], smoke=True,
                               device="cpu")
        batches = [tuple(jnp.asarray(t.numpy()) for t in tc.batch_at(i))
                   for i in range(1, STEPS)]
    fn = compiled(jc.fn, state, *batches[0])
    p0 = {k: np.asarray(a) for k, a in jflat(state["params"])}
    rms = None
    for b in batches:
        state, m = fn(state, *b)
        t = int(state["opt"].count)
        now = {k: np.sqrt(np.asarray(v) / (1 - 0.95 ** t))
               for k, v in jflat(state["opt"].v)}
        rms = now if rms is None else {k: np.minimum(rms[k], now[k])
                                       for k in now}
    return {"loss": float(m["loss"]), "gnorm": float(m["gnorm"]),
            "state": {k: np.asarray(a) for k, a in jflat(state)},
            "p0": p0, "rms": rms}


def test_the_packages_states_have_the_same_leaves(spawned):
    """The JAX smoke cells' states and the port's have the same keys,
    shapes and dtypes: the port restores the JAX checkpoint as it is.
    (The ranks start first: they wait for these cells' checkpoints.)"""
    for arch in ARCHS:
        tc = tsteps.build_cell(arch, bodies.CELLS[arch], smoke=True,
                               device="cpu")
        want = [(k, tuple(a.shape), str(a.numpy().dtype))
                for k, a in flatten_with_paths(tc.args[0])]
        assert [(k, tuple(np.shape(a)), str(np.asarray(a).dtype))
                for k, a in jflat(_jax_cell(arch)[1])] == want, arch


def _read(path, arch):
    """The port's checkpoint at ``path`` through the JAX loader."""
    got, extra = jload(path, _jax_cell(arch)[1])
    return {k: np.asarray(a) for k, a in jflat(got)}, extra


def check_against_jax(arch, path, res):
    """The bounds of the module docstring."""
    want = jax_reference(arch)
    got, extra = _read(path, arch)
    assert extra == {"step": STEPS - 1}
    assert res["step"] == STEPS - 1
    lr, n = LR[arch], STEPS - 1
    assert int(got["opt/count"]) == int(want["state"]["opt/count"]) \
        == COUNT0.get(arch, 0) + n
    if arch == "glm4-9b":
        np.testing.assert_allclose(res["loss"], want["loss"], rtol=1e-3)
        np.testing.assert_allclose(res["gnorm"], want["gnorm"], rtol=REL_L2)
    else:
        np.testing.assert_allclose(res["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(res["gnorm"], want["gnorm"], rtol=1e-5)
    for k, w in want["state"].items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k == "opt/count":
            continue
        kind, leaf = k.split("/", 1)
        if kind == "opt":
            moment = leaf[0]
            if arch == "glm4-9b":
                bound = REL_L2 * (2 if moment == "v" else 1)
                assert np.linalg.norm(g - w) <= bound * np.linalg.norm(w), k
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5,
                                           atol=1e-5 * np.abs(w).max(),
                                           err_msg=k)
            continue
        err, r = np.abs(g - w), want["rms"][leaf]
        if arch == "glm4-9b":
            assert (err <= 2 * lr * n).all(), k
            continue
        if arch == "gcn-cora":
            p0 = want["p0"][leaf]
            up, wup = g - p0, w - p0
            noisy = r < 1e-3 * r.max()
            bad = np.abs(up - wup) > 1e-4 * np.abs(wup) \
                + 1e-4 * np.abs(wup).max()
        else:
            noisy = (r > 0) & (r < 1e-7)
            bad = err > 1e-5
        assert bad.sum() <= max(2, 1e-4 * bad.size), k
        assert not (bad & ~noisy).any(), k
        assert (err[noisy] <= 2 * lr * n).all(), k


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world", [2, 4])
def test_cli_on_a_mesh_resumes_a_jax_checkpoint(root, results, world,
                                                arch):
    res = results[world]
    (out, log) = res[0][("full", arch)]
    assert "resumed from step 0" in log and log.rstrip().endswith("done")
    for r in res[1:]:                          # the ranks agree
        assert r[("full", arch)][0] == out
        assert r[("full", arch)][1] == ""      # rank 0 alone logs
    check_against_jax(arch, os.path.join(_dir(root, f"w{world}", arch),
                                         "step_00000003"), out)


@pytest.mark.parametrize("arch", ARCHS)
def test_cut_and_resumed_run_is_the_uninterrupted_one(root, results, arch):
    out, log = results[4][0][("resume", arch)]
    assert "resumed from step 2" in log
    assert out == results[4][0][("full", arch)][0]
    whole = os.path.join(_dir(root, "w4", arch), "step_00000003")
    cut = os.path.join(_dir(root, "resume", arch), "step_00000003")
    names = sorted(os.listdir(whole))
    assert names == sorted(os.listdir(cut)) and len(names) > 2
    for name in names:
        with open(os.path.join(whole, name), "rb") as a, \
                open(os.path.join(cut, name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("arch", ARCHS)
def test_cut_run_resumed_on_half_the_world(root, results, arch):
    out, log = results[2][0][("half", arch)]
    assert "resumed from step 2" in log
    check_against_jax(arch, os.path.join(_dir(root, "half", arch),
                                         "step_00000003"), out)


@functools.lru_cache(maxsize=None)
def unsharded_elastic():
    """gcn-cora's unsharded smoke cell: its parameters before and after
    ELASTIC["steps"] steps, and each element's least RMS gradient."""
    cell = tsteps.build_cell("gcn-cora", "full_graph_sm", smoke=True,
                             device="cpu")
    state = cell.args[0]
    p0 = [t.clone().numpy() for _, t in flatten_with_paths(state["params"])]
    rms = None
    for i in range(ELASTIC["steps"]):
        cell.fn(state, *cell.batch_at(i))
        now = [np.sqrt(v.numpy() / (1 - 0.95 ** (i + 1)))
               for _, v in flatten_with_paths(state["opt"].v)]
        rms = now if rms is None else [np.minimum(a, b)
                                       for a, b in zip(rms, now)]
    return p0, [t.numpy() for _, t in flatten_with_paths(state["params"])], \
        rms


def test_elastic_trainer_recuts_onto_the_survivors(results):
    got = [r["elastic"] for r in results[4]]
    saved = max(s for s in range(ELASTIC["fail"])
                if (s + 1) % ELASTIC["every"] == 0)
    for rank, r in enumerate(got):
        log = r["log"]
        assert log["restarts"] == 1 and log["meshes"] == [(4, 1), (2, 1)][
            :1 + (rank < ELASTIC["survivors"])]
        if rank >= ELASTIC["survivors"]:
            assert r["state"] is None
            continue
        assert log["resumed_from"] == [saved]
        assert r["count"] == ELASTIC["steps"]
    p0, want, rms = unsharded_elastic()
    for a, b in zip(got[0]["params"], got[1]["params"]):
        np.testing.assert_array_equal(a, b)
    for g, w, w0, r in zip(got[0]["params"], want, p0, rms):
        up, wup = g - w0, w - w0
        bad = np.abs(up - wup) > 1e-4 * np.abs(wup) + 1e-4 * np.abs(wup).max()
        noisy = r < 1e-3 * r.max()
        assert bad.sum() <= max(2, 1e-4 * bad.size)
        assert not (bad & ~noisy).any()
        assert (np.abs(g - w)[noisy] <= 2 * LR["gcn-cora"]
                * ELASTIC["steps"]).all()
