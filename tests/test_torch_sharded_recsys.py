"""Sharded training of dlrm-rm2 against the JAX package's unsharded cell.

rm2's smoke train_batch cell, built by ``steps.build_cell`` under
``rules_recsys`` on gloo meshes (1, 1), (1, 2), (2, 1) and (2, 2): each
table's 1,000 rows split over ``model`` (``bag_sum`` and its backward on
the rank's ``[26 * V_l, D]`` block, ids outside it sent past the end),
the batch of 8 over ``data``.  Each rank takes the gradient at the same
parameters (``dlrm_value_and_grad``: the whole batch's loss, every block
summed over the data axes) and 3 steps of the cell on its batch
(``torchdist_train_bodies.rm2_case``); the table's gradient, parameters
and AdamW m and v come back joined (``gather_blocks``).  The reference
is JAX's unsharded smoke cell from the same parameters (the port's
``init_params`` at seed 0, as numpy), as ``tests/test_torch_train.py``
runs it.  The cell as ``build_cell`` makes it under its rules at worlds
1 and 4 steps with the unsharded cell's loss.  On one process: the
rank's lookup of a row block, whose ids outside it go past the end,
gives the rows of the unsharded gradient that the block holds and adds
to no other row.

Bounds (``tests/test_torch_train.py``'s for the DLRM): the loss and
every gradient leaf rtol 1e-5 with atol 1e-7; the loss and gnorm of each
step rtol 1e-5; m and v rtol 1e-5 with an atol of 1e-5 of each leaf's
largest magnitude; the parameters atol 1e-5, except at most 2 elements
(or 1e-4 of a leaf) whose RMS gradient fell below 1e-7, within 2 lr a
step.  Every rank of a mesh reports the same losses and norms.  The
world-1 cell step's loss is the unsharded cell's bit for bit, world 4's
within rtol 1e-6.  The block lookup's gradient: bit for bit.

One spawn of 4 ranks runs every mesh, started before the JAX reference
is computed.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as jsteps
from repro.optim import adamw_init as j_adamw_init
from repro_torch.models import dlrm as td
from repro_torch.tree import flatten_with_paths
import torchdist
import torchdist_train_bodies as bodies
from test_torch_sharded_lm import compiled

RM2 = ("rm2",)
STEP = ("step", "dlrm-rm2", "train_batch")
STAGES = [
    [((2, 2), (0, 1, 2, 3), [RM2])],
    [((1, 2), (0, 1), [RM2]), ((2, 1), (2, 3), [RM2])],
    [((1, 4), (0, 1, 2, 3), [STEP])],
    [((1, 1), (0,), [RM2, STEP])],
]
MESHES = [((2, 2), (0, 1, 2, 3)), ((1, 2), (0, 1)), ((2, 1), (2, 3)),
          ((1, 1), (0,))]
LR = 1e-3                  # the DLRM train step's


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with torchdist.one_thread():
        yield


@functools.lru_cache(maxsize=None)
def _params():
    return bodies.params_np("dlrm-rm2", "train_batch")


@pytest.fixture(scope="module")
def spawned():
    ranks = torchdist.Ranks(4, "torchdist_train_bodies:train_battery",
                            {"rm2": _params(), "stages": STAGES},
                            timeout=300.0)
    yield ranks
    ranks.close()


@functools.lru_cache(maxsize=None)
def jax_cell():
    """JAX's unsharded smoke train cell from the payload's parameters:
    loss and gradients, then 3 steps on its batch (losses, norms, the
    state, each step's RMS gradient)."""
    jc = jsteps.build_cell("dlrm-rm2", "train_batch", smoke=True)
    cfg, batch = jc.meta["cfg"], jc.args[1:]
    from repro.models import dlrm as jd
    params = jax.tree.map(jnp.asarray, _params())
    loss, grads = compiled(jax.value_and_grad(
        lambda p, *b: jd.loss_fn(p, *b, cfg)), params, *batch)(params,
                                                                *batch)
    state = {"params": params, "opt": j_adamw_init(params)}
    step = compiled(jc.fn, state, *batch)
    losses, gnorms, rms = [], [], None
    leaves_np = lambda t: [np.asarray(a) for a in jax.tree.leaves(t)]  # noqa
    for t in range(1, bodies.STEPS + 1):
        state, m = step(state, *batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
        now = [np.sqrt(v / (1 - 0.95 ** t)) for v in leaves_np(
            state["opt"].v)]
        rms = now if rms is None else [np.minimum(a, b)
                                       for a, b in zip(rms, now)]
    return {"loss0": float(loss), "grads": leaves_np(grads),
            "losses": losses, "gnorms": gnorms, "rms": rms,
            "params": leaves_np(state["params"]),
            "m": leaves_np(state["opt"].m), "v": leaves_np(state["opt"].v),
            "batch": [np.asarray(b) for b in batch]}


@pytest.fixture(scope="module")
def results(spawned):
    jax_cell()
    return spawned.results()


def _get(results, mesh, case):
    shape, ranks = mesh
    i = next(j for stage in STAGES for s, r, cases in stage
             if (s, r) == mesh for j, c in enumerate(cases) if c == case)
    return [results[r][shape, ranks, i] for r in ranks]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0][0]}x{m[0][1]}")
def test_sharded_rm2_train_cell_matches_jax(results, mesh):
    got = _get(results, mesh, RM2)
    first, want = got[0], jax_cell()
    for other in got[1:]:                       # the ranks agree
        for k in ("loss0", "losses", "gnorms", "count"):
            assert other[k] == first[k], k
    n_data, n_model = mesh[0]
    assert first["rows"] * n_model == 1000      # the rank's rows
    assert first["batch"] * n_data == want["batch"][0].shape[0]
    assert first["count"] == bodies.STEPS
    np.testing.assert_allclose(first["loss0"], want["loss0"], rtol=1e-5)
    paths = [k for k, _ in flatten_with_paths(_params())]
    assert len(first["grads"]) == len(want["grads"]) == len(paths)
    for k, g, w in zip(paths, first["grads"], want["grads"]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7,
                                   err_msg=f"grad {k}")
    assert np.abs(first["grads"][paths.index("tables")]).max() > 0
    np.testing.assert_allclose(first["losses"], want["losses"], rtol=1e-5)
    np.testing.assert_allclose(first["gnorms"], want["gnorms"], rtol=1e-5)
    for name in ("m", "v"):
        for k, g, w in zip(paths, first[name], want[name]):
            np.testing.assert_allclose(g, w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"{name} {k}")
    for k, p, w, r in zip(paths, first["params"], want["params"],
                          want["rms"]):
        err = np.abs(p - w)
        noisy = (r > 0) & (r < 1e-7)
        assert (err > 1e-5).sum() <= max(2, 1e-4 * (r > 0).sum()), k
        assert (err[~noisy] <= 1e-5).all(), k
        assert (err[noisy] <= 2 * LR * bodies.STEPS).all(), k


@pytest.mark.parametrize("world", [1, 4])
def test_rm2_cell_runs_on_a_mesh(results, world):
    """dlrm-rm2 train_batch built under ``rules_recsys`` on ``world``
    ranks takes a step with the unsharded cell's loss."""
    mesh = ((1, 1), (0,)) if world == 1 else ((1, 4), (0, 1, 2, 3))
    got = _get(results, mesh, STEP)
    want = bodies.unsharded_first_loss("dlrm-rm2", "train_batch")
    assert len(set(got)) == 1
    if world == 1:
        assert got[0] == want
    else:
        np.testing.assert_allclose(got[0], want, rtol=1e-6)


@pytest.mark.parametrize("n_blocks", [2, 4])
def test_block_lookup_sends_other_ids_past_the_end(n_blocks):
    """``dlrm._lookup`` of a rank's row block (``lo`` its first row): the
    gradient of its ``bag_sum`` lands on the block's rows as the
    unsharded lookup's does, bit for bit, and an id outside the block
    (sent past the end) adds to no row; the blocks' gradients make up
    the unsharded one."""
    rng = np.random.default_rng(n_blocks)
    t, v, d, b = 3, 40, 5, 16
    tables = torch.from_numpy(rng.normal(size=(t, v, d)).astype(np.float32))
    ids = torch.from_numpy(np.minimum(rng.zipf(1.3, (b, t)) - 1,
                                      v - 1).astype(np.int32))
    cot = torch.from_numpy(rng.normal(size=(b, t, d)).astype(np.float32))

    def grad(tab, lo):
        tab = tab.clone().requires_grad_(True)
        out = td._lookup(tab, ids, lo)
        out.backward(cot)
        return out.detach(), tab.grad
    whole_out, whole = grad(tables, 0)
    per = v // n_blocks
    parts = []
    for r in range(n_blocks):
        out, g = grad(tables[:, r * per:(r + 1) * per], r * per)
        mine = (ids >= r * per) & (ids < (r + 1) * per)
        assert not out[~mine].any()             # a zero row for the rest
        torch.testing.assert_close(out[mine], whole_out[mine], rtol=0,
                                   atol=0)
        torch.testing.assert_close(g, whole[:, r * per:(r + 1) * per],
                                   rtol=0, atol=0)
        parts.append(g)
    torch.testing.assert_close(torch.cat(parts, dim=1), whole, rtol=0,
                               atol=0)
    _, none = grad(tables[:, :per], v)          # every id outside
    assert not none.any()
