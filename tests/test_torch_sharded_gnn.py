"""Sharded training of the port's GNN family against the JAX package's
unsharded cells.

Each arch's smoke train cell (gcn-cora and gin-tu on full_graph_sm,
gin-tu on molecule for its graph readout, schnet and equiformer-v2 on
molecule), built by ``steps.build_cell`` under ``rules_gnn`` with the
base layout and with ``variant="opt"`` (GCN, GIN and SchNet
"partitioned": the edges bucketed by destination owner), on gloo meshes
(1, 1), (2, 1), (1, 3) and (2, 2): 1 to 4 ranks over the nodes and
edges.  The (1, 3) mesh pads full_graph_sm's 64 nodes to 66 and its 256
edges to 258; (2, 2) puts the node blocks over both axes.  Each rank
takes the gradient at the same parameters (``gnn_value_and_grad``) and
3 steps of the cell (``torchdist_train_bodies.gnn_case``).  The
reference is JAX's unsharded smoke cell from the same parameters (the
port's ``init_params`` at seed 0, as numpy): ``value_and_grad`` of its
loss and 3 steps of its step function (the JAX smoke cell ignores the
variant: either layout computes its loss).

EquiformerV2's ``dst_ranged`` chunks (``dst_ranged_case``): 62 nodes
and 256 edges bucketed into 4 chunks of 80 (as
``tests/test_torch_gnn.py`` buckets them), laid out by
``gnn_mesh_layout`` for the mesh (the nodes padded to 64, 16 a chunk)
and held to JAX's unsharded ``dst_ranged`` loss and gradients; the (1, 3)
mesh, whose 3 node blocks the 4 chunks do not fall in, raises, naming
the arch and the mesh.  ``common``'s primitives on blocks
(``prims_case``: ``scatter_max``, ``degrees``, ``segment_softmax`` and
the mean ``graph_readout``, sentinel indices and an empty segment
included) against the unsharded functions.  And gcn-cora's smoke
full_graph_sm cell as ``build_cell`` makes it under its rules at worlds
1 and 4 steps with the unsharded cell's loss.

Bounds, f32 (``tests/test_torch_gnn.py``'s): the loss, per step, and
gnorm rtol 1e-5; every gradient leaf rtol 1e-4 with an atol of 1e-5 of
the leaf's largest magnitude; AdamW's m and v after 3 steps rtol 1e-5
with an atol of 1e-5 of each leaf's largest magnitude; the update ``p -
p0`` rtol 1e-4 with an atol of 1e-4 of the leaf's largest update, where
an element's step is set by f32 noise (its first gradient cancels to
below 1e-3 of the leaf's largest; at most 2 elements, or 1e-4 of the
leaf) within 2 lr a step, as ``tests/test_torch_train.py`` bounds
Adam's ill-conditioned steps (measured: one element of schnet's
``interactions/0/out/1/0`` at (2, 2), its first gradient -2.433e-7
against JAX's -2.443e-7, its update off by 1.0e-6 of 3e-3).
Every rank of a mesh reports the same losses and norms.  The primitives:
maxima and degrees bit for bit, the softmax and readout rtol 1e-6 with
atol 1e-7 (sums in another order).  The world-1 cell step's loss is the
unsharded cell's bit for bit, world 4's within rtol 1e-6.

One spawn of 4 ranks runs every mesh, started before the JAX references
are computed.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.configs.shapes import SHAPE_PARAMS
from repro.data import graphs as jgraphs
from repro.launch import steps as jsteps
from repro.optim import adamw_init as j_adamw_init
from repro_torch.data import make_graph_batch
from repro_torch.launch import steps as tsteps
from repro_torch.models.convert import local_blocks
from repro_torch.models.gnn import common as tcommon
from repro_torch.models.gnn.common import GraphBatch
from repro_torch.tree import flatten_with_paths, leaves, unflatten
import torchdist
import torchdist_train_bodies as bodies
from test_torch_sharded_lm import compiled

CELLS = [("gcn-cora", "full_graph_sm"), ("gin-tu", "full_graph_sm"),
         ("gin-tu", "molecule"), ("schnet", "molecule"),
         ("equiformer-v2", "molecule")]
GNN = [("gnn", arch, shape, v) for arch, shape in CELLS
       for v in ("base", "opt")]
EACH = GNN + [("dst_ranged",), ("prims",)]
STEP = ("step", "gcn-cora", "full_graph_sm")
STAGES = [
    [((2, 2), (0, 1, 2, 3), EACH)],
    [((1, 3), (0, 1, 2), EACH), ((1, 1), (3,), EACH + [STEP])],
    [((2, 1), (0, 1), EACH)],
    [((1, 4), (0, 1, 2, 3), [STEP])],
]
MESHES = [(shape, ranks) for stage in STAGES for shape, ranks, c in stage
          if c[0] != STEP]
LR = 1e-3                  # the GNN train step's
DST = {"n": 62, "e": 256, "buckets": 4, "pad": 1.25, "edge_chunk": 80}
PRIMS_N, PRIMS_E = 12, 60


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with torchdist.one_thread():
        yield


@functools.lru_cache(maxsize=None)
def _params(arch, shape):
    return bodies.params_np(arch, shape)


@functools.lru_cache(maxsize=None)
def jax_smoke_cell(arch, shape):
    """(config, batch, step function) of JAX's smoke cell, as
    ``jsteps.build_cell(arch, shape, smoke=True)`` makes them, without
    its parameters (the payload's replace them; drawing them from a
    PRNG key takes longer than the cell's compiles)."""
    sp = dict(SHAPE_PARAMS["gnn"][shape])
    cfg = jsteps._gnn_cell_config(
        arch, jax_arch(arch).smoke_config(),
        {**sp, "d_feat": min(sp.get("d_feat", 16), 32),
         "n_classes": sp["n_classes"]}, smoke=True)
    batch = jsteps._gnn_concrete_batch(arch, sp)
    cfg = dataclasses.replace(cfg, d_in=(batch.node_feat.shape[1]
                                         if batch.node_feat.ndim == 2
                                         else 0))
    return cfg, batch, jsteps._gnn_train_step(jsteps.GNN_MODULES[arch], cfg)


def _dst_cfg():
    return dataclasses.replace(
        jax_smoke_cell("equiformer-v2", "full_graph_sm")[0],
        edge_layout="dst_ranged", edge_chunk=DST["edge_chunk"])


def _prims():
    rng = np.random.default_rng(26)
    idx = rng.integers(0, PRIMS_N + 1, PRIMS_E).astype(np.int32)  # n: sentinel
    idx[idx == 5] = 6                                   # segment 5 empty
    return {"idx": idx,
            "vals": (rng.normal(size=(PRIMS_E, 3)) * 4).astype(np.float32),
            "x": rng.normal(size=(PRIMS_N, 3)).astype(np.float32),
            "gids": rng.integers(0, 4, PRIMS_N).astype(np.int32)}


@pytest.fixture(scope="module")
def spawned():
    dst_params = bodies.params_np("equiformer-v2", "full_graph_sm")
    payload = {"params": {c: _params(*c) for c in CELLS}, "stages": STAGES,
               "dst": dict(DST, params=dst_params), "prims": _prims()}
    ranks = torchdist.Ranks(4, "torchdist_train_bodies:train_battery",
                            payload, timeout=300.0)
    yield ranks
    ranks.close()


@functools.lru_cache(maxsize=None)
def jax_cell(arch, shape):
    """JAX's unsharded smoke cell from the payload's parameters: loss and
    gradients, then 3 steps (losses, norms, the state)."""
    cfg, batch, fn = jax_smoke_cell(arch, shape)
    mod = jsteps.GNN_MODULES[arch]
    params = jax.tree.map(jnp.asarray, _params(arch, shape))

    def grads_and_step(state, g):   # one compile: XLA shares the gradient
        return jax.value_and_grad(lambda p: mod.loss_fn(p, g, cfg))(
            state["params"]), fn(state, g)
    state = {"params": params, "opt": j_adamw_init(params)}
    run = compiled(grads_and_step, state, batch)
    losses, gnorms = [], []
    for i in range(bodies.STEPS):
        vg, (state, m) = run(state, batch)
        if i == 0:
            loss, grads = vg
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
    leaves_np = lambda t: [np.asarray(a) for a in jax.tree.leaves(t)]  # noqa
    return {"loss0": float(loss), "grads": leaves_np(grads),
            "losses": losses, "gnorms": gnorms,
            "p0": leaves_np(params), "params": leaves_np(state["params"]),
            "m": leaves_np(state["opt"].m), "v": leaves_np(state["opt"].v)}


@functools.lru_cache(maxsize=None)
def jax_dst_ranged():
    """JAX's unsharded ``dst_ranged`` loss and gradients on the bucketed
    graph."""
    from repro.models.gnn import equiformer_v2 as jeq
    cfg = _dst_cfg()
    g = jgraphs.bucket_edges_by_dst(jgraphs.make_graph_batch(
        n_nodes=DST["n"], n_edges=DST["e"], d_feat=cfg.d_in, n_classes=7),
        DST["buckets"], pad_factor=DST["pad"])
    params = jax.tree.map(jnp.asarray,
                          bodies.params_np("equiformer-v2", "full_graph_sm"))
    loss, grads = compiled(jax.value_and_grad(
        lambda p, b: jeq.loss_fn(p, b, cfg)), params, g)(params, g)
    return float(loss), [np.asarray(a) for a in jax.tree.leaves(grads)]


@pytest.fixture(scope="module")
def results(spawned):
    """Every reference first (the ranks run meanwhile), then the ranks'
    results."""
    for cell in CELLS:
        jax_cell(*cell)
    jax_dst_ranged()
    return spawned.results()


def _close(got, want, rtol, scale, what):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=scale * np.abs(want).max(), err_msg=what)


def _mesh_id(m):
    return f"{m[0][0]}x{m[0][1]}"


def _get(results, mesh, case):
    shape, ranks = mesh
    i = next(j for stage in STAGES for s, r, cases in stage
             if (s, r) == mesh for j, c in enumerate(cases) if c == case)
    return [results[r][shape, ranks, i] for r in ranks]


@pytest.mark.parametrize("case", GNN, ids=lambda c: f"{c[1]}-{c[2]}-{c[3]}")
@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
def test_sharded_gnn_cells_match_jax(results, mesh, case):
    _, arch, shape, _ = case
    got = _get(results, mesh, case)
    first, want = got[0], jax_cell(arch, shape)
    for other in got[1:]:                       # the ranks agree
        for k in ("loss0", "losses", "gnorms", "n_nodes", "count"):
            assert other[k] == first[k], k
    n_ranks = mesh[0][0] * mesh[0][1]
    assert first["n_nodes"] % n_ranks == 0
    if (shape, n_ranks) == ("full_graph_sm", 3):
        assert first["n_nodes"] == 66           # 64 nodes padded
    assert first["count"] == bodies.STEPS
    np.testing.assert_allclose(first["loss0"], want["loss0"], rtol=1e-5)
    paths = [k for k, _ in flatten_with_paths(_params(arch, shape))]
    assert len(first["grads"]) == len(want["grads"]) == len(paths)
    for k, g, w in zip(paths, first["grads"], want["grads"]):
        _close(g, w, 1e-4, 1e-5, f"grad {k}")
    np.testing.assert_allclose(first["losses"], want["losses"], rtol=1e-5)
    np.testing.assert_allclose(first["gnorms"], want["gnorms"], rtol=1e-5)
    for name in ("m", "v"):
        for k, g, w in zip(paths, first[name], want[name]):
            _close(g, w, 1e-5, 1e-5, f"{name} {k}")
    moved = 0
    for k, p, w, w0, g in zip(paths, first["params"], want["params"],
                              want["p0"], want["grads"]):
        moved += bool(np.abs(w - w0).max() > 0)
        check_update(p - w0, w - w0, g, k)
    assert moved > len(paths) // 2


def check_update(got, want, grad, what):
    """The update ``p - p0`` against JAX's: rtol 1e-4 with an atol of
    1e-4 of the leaf's largest update, except on a few elements (at most
    2, or 1e-4 of the leaf) whose first gradient cancels (below 1e-3 of
    the leaf's largest): their Adam steps ``m / sqrt(v)`` follow the
    f32 noise of the ranks' sum order, within ``2 lr`` a step."""
    err = np.abs(got - want)
    bad = err > 1e-4 * np.abs(want) + 1e-4 * np.abs(want).max()
    if not bad.any():
        return
    cancels = np.abs(grad) < 1e-3 * np.abs(grad).max()
    assert (bad & ~cancels).sum() == 0, what
    assert bad.sum() <= max(2, 1e-4 * bad.size), what
    assert (err[bad] <= 2 * LR * bodies.STEPS).all(), what


@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
def test_dst_ranged_chunks_on_node_blocks(results, mesh):
    got = _get(results, mesh, ("dst_ranged",))
    n_ranks = mesh[0][0] * mesh[0][1]
    if DST["buckets"] % n_ranks:
        for r in got:
            msg = r["raised"]
            assert "equiformer-v2" in msg and "dst_ranged" in msg
            assert f"mesh {mesh[0][0]}x{mesh[0][1]}" in msg
        return
    first = got[0]
    for other in got[1:]:
        assert other["loss0"] == first["loss0"]
    # the ranges are the padded graph's: 16 nodes a chunk
    assert first["n_nodes"] == (DST["n"] if n_ranks == 1 else 64)
    assert first["edges"] == 320                # 4 chunks of 80
    loss, grads = jax_dst_ranged()
    np.testing.assert_allclose(first["loss0"], loss, rtol=1e-5)
    assert len(first["grads"]) == len(grads)
    for i, (g, w) in enumerate(zip(first["grads"], grads)):
        _close(g, w, 1e-4, 1e-5, f"grad {i}")


def _prims_unsharded():
    p = {k: torch.from_numpy(v) for k, v in _prims().items()}
    n = PRIMS_N
    return {"max": tcommon.scatter_max(p["vals"], p["idx"], n).numpy(),
            "deg": tcommon.degrees(p["idx"], n).numpy(),
            "softmax": tcommon.segment_softmax(p["vals"], p["idx"],
                                               n).numpy(),
            "readout": tcommon.graph_readout(p["x"], p["gids"], 4,
                                             op="mean").numpy()}


@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
def test_segment_primitives_on_blocks(results, mesh):
    want = _prims_unsharded()
    for got in _get(results, mesh, ("prims",)):
        np.testing.assert_array_equal(got["max"], want["max"])
        np.testing.assert_array_equal(got["deg"], want["deg"])
        for k in ("softmax", "readout"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=1e-7, err_msg=k)


@pytest.mark.parametrize("world", [1, 4])
def test_gcn_cell_runs_on_a_mesh(results, world):
    """gcn-cora full_graph_sm built under ``rules_gnn`` on ``world``
    ranks takes a step with the unsharded cell's loss."""
    mesh = ((1, 1), (3,)) if world == 1 else ((1, 4), (0, 1, 2, 3))
    got = _get(results, mesh, STEP)
    want = bodies.unsharded_first_loss("gcn-cora", "full_graph_sm")
    assert len(set(got)) == 1
    if world == 1:
        assert got[0] == want
    else:
        np.testing.assert_allclose(got[0], want, rtol=1e-6)


# ---------------------------------------------------------------------------
# the trees of a graph batch, on one process
# ---------------------------------------------------------------------------

def test_graph_batch_is_a_tree_of_its_data_fields():
    """A ``GraphBatch`` is an inner node over its data fields in the JAX
    ``register_dataclass`` order (None fields empty), its counts
    metadata: leaves, paths and ``unflatten`` see the tensors."""
    g = make_graph_batch(10, 30, 4, device="cpu")
    assert g.graph_ids is None
    want = [k for k in GraphBatch.TENSORS if getattr(g, k) is not None]
    assert [k for k, _ in flatten_with_paths(g)] == want
    assert all(a is getattr(g, k) for a, k in zip(leaves(g), want))
    h = unflatten(g, [t + 0 for t in leaves(g)])
    assert isinstance(h, GraphBatch) and (h.n_nodes, h.n_graphs) == (10, 1)
    assert all(torch.equal(a, b) for a, b in zip(leaves(h), leaves(g)))
    assert h.graph_ids is None and h.src is not g.src


class _Mesh:
    """A mesh's names, sizes and this rank's coordinate: all that
    ``local_block`` reads (no group)."""
    mesh_dim_names = ("data", "model")

    def __init__(self, shape, coord):
        self.shape, self.coord = shape, coord

    def size(self, dim=None):
        return self.shape[0] * self.shape[1] if dim is None \
            else self.shape[dim]

    def get_coordinate(self):
        return list(self.coord)


@pytest.mark.parametrize("coord", [(0, 0), (1, 0), (1, 1)])
def test_local_blocks_of_a_graph_batch(coord):
    """``convert.local_blocks`` of a graph batch under the cell's
    sharding tree (rules_gnn on a 2x2 mesh): node tensors and edges cut
    to the rank's quarter (row-major over data and model), a
    graph-level label whole, the counts kept."""
    from repro_torch import shardlib as sl
    from repro_torch.launch.mesh import rules_gnn
    mesh = _Mesh((2, 2), coord)
    g = make_graph_batch(16, 40, 3, n_graphs=3, device="cpu")
    g = dataclasses.replace(g, labels=torch.arange(3))
    with sl.axis_rules(mesh, rules_gnn(mesh)):
        sh = tsteps._gnn_batch_shardings(g)
        got = local_blocks(g, sh)
    i = coord[0] * 2 + coord[1]
    assert (got.n_nodes, got.n_graphs) == (16, 3)
    for k in ("src", "dst", "edge_feat"):
        torch.testing.assert_close(getattr(got, k),
                                   getattr(g, k)[i * 10:(i + 1) * 10])
    for k in ("node_feat", "graph_ids", "train_mask"):
        torch.testing.assert_close(getattr(got, k),
                                   getattr(g, k)[i * 4:(i + 1) * 4])
    assert got.labels is g.labels
