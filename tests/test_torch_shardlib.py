"""The port's shardlib and mesh rules against the JAX package's, and its
collectives over gloo groups of 2, 3 and 4 ranks against numpy.

Spec resolution needs no group: the port's ``logical_to_spec`` under
each rule set over a stand-in of the ``(1, 1)`` smoke mesh (its dim
names and sizes, which is all resolution reads) against JAX's under
``make_smoke_mesh()``.  Then one gloo group a world size
(``torchdist.run_ranks``, module fixture) runs every case, and the cases
below assert its results: ``axis_index`` order, ``psum``/``pmax``/
``pmin``/``psum_scatter``/``all_gather`` over each axis tuple of each
mesh, the backward of each autograd collective (and ``enter``'s),
blocks and their gather, ``surviving_mesh``, and
``compressed_mean`` over the data group.
"""
import numpy as np
import pytest

import repro.launch.mesh as jmesh
import repro.shardlib as jsl
import repro_torch.launch.mesh as tmesh
import repro_torch.shardlib as tsl
from repro_torch.optim.compress import dequantize_int8, quantize_int8
import torch
import torchdist
import torchdist_bodies as bodies


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with torchdist.one_thread():
        yield


RULE_SETS = ("rules_train_lm", "rules_serve_lm", "rules_gnn", "rules_recsys")
NAMES = [("batch", "seq", None), (None, None), ("heads", "mlp"),
         ("batch", "kv_seq", None, None), ("vocab", "fsdp"),
         ("fsdp", "heads"), ("nodes", None), ("edges",), ("rows", None),
         ("cand",), ("layer_stack", "batch", "kv_seq", None, None),
         ("expert", "fsdp", None), ("model_dim",), ("batch", "nodes"),
         ("nodes", "rows"), ("unbound", "batch")]


def _norm(spec):
    """jax 0.9's ``P`` turns a one-axis tuple into the axis name; the
    port's spec keeps the rule's tuple, as JAX's ``logical_to_spec``
    builds it."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


class _StandIn:
    """The smoke mesh's names and sizes (what rules and resolution read)."""
    mesh_dim_names = ("data", "model")

    def size(self, dim=None):
        return 1


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("rule_set", RULE_SETS)
def test_rules_and_specs_match_jax(rule_set, batch):
    jm = jmesh.make_smoke_mesh()
    tm = _StandIn()
    jr = getattr(jmesh, rule_set)(jm, batch)
    tr = getattr(tmesh, rule_set)(tm, batch)
    assert tr == jr
    for names in NAMES:
        with jsl.axis_rules(jm, jr):
            want = tuple(jsl.logical_to_spec(*names))
        with tsl.axis_rules(tm, tr):
            got = tsl.logical_to_spec(*names)
            assert tsl.sharding_for(*names).spec == got
        assert _norm(got) == want, names
        assert tsl.logical_to_spec(*names) == ()      # outside the rules


def test_production_mesh_shapes():
    assert tmesh.production_mesh_shape() == ((16, 16), ("data", "model"))
    assert tmesh.production_mesh_shape(multi_pod=True) == \
        ((2, 16, 16), ("pod", "data", "model"))


def test_helpers_without_a_mesh():
    x = torch.ones(3)
    for fn in (tsl.psum, tsl.pmax, tsl.pmin, tsl.psum_scatter,
               tsl.all_gather):
        assert fn(x, ()) is x
    assert tsl.shard(x, "batch") is x
    assert tsl.axis_size(("data",)) == 1 and tsl.axis_index(()) == 0
    assert tsl.maybe_shard_map(len, (), ()) is len
    assert tsl.local_block(x, tsl.P("data")) is x


def _grads(rank):
    """Dyadic values: every sum of the ranks' leaves is exact in f32, so
    the mean is exact in any order."""
    rng = np.random.default_rng(100 + rank)
    return {"a": (rng.integers(-512, 512, (16, 8)) / 8).astype(np.float32),
            "b": (rng.integers(-512, 512, (7,)) / 16).astype(np.float32)}


def _noise(rank):
    rng = np.random.default_rng(200 + rank)
    return {k: rng.random(v.shape, dtype=np.float32)
            for k, v in _grads(rank).items()}


@pytest.fixture(scope="module", autouse=True)
def spawned():
    """One spawn of 4 ranks: gloo groups of 4, 3 and 2 ranks (the first
    w; ``torchdist_bodies.worlds``), started with the module (the spec
    cases run meanwhile) and collected by the first case of a world."""
    payload = {"grads": [_grads(r) for r in range(4)],
               "noise": [_noise(r) for r in range(4)]}
    ranks = torchdist.Ranks(4, "torchdist_bodies:shardlib_battery",
                            payload, timeout=120.0)
    yield ranks
    ranks.close()


@pytest.fixture(scope="module", params=[2, 3, 4])
def world(request, spawned):
    w = request.param
    return w, [spawned.results()[r][w] for r in range(w)]


def _groups(shape, axes, rank):
    """Global ranks of ``rank``'s group over ``axes``, in axis_index
    (row-major over ``axes`` as given) order."""
    names = ("data", "model")
    grid = np.arange(int(np.prod(shape))).reshape(shape)
    coord = [int(c[0]) for c in np.nonzero(grid == rank)]
    dims = [names.index(a) for a in axes]
    idx = [slice(None) if d in dims else coord[d] for d in range(2)]
    sub = grid[tuple(idx)]
    kept = [d for d in range(2) if d in dims]
    return sub.transpose([kept.index(d) for d in dims]).reshape(-1)


@pytest.mark.parametrize("axes", bodies.AXES, ids="+".join)
def test_collectives_match_numpy(world, axes):
    w, outs = world
    k = "+".join(axes)
    for shape in bodies.SHARDLIB_MESHES[w]:
        for rank, out in enumerate(outs):
            r = out[shape]
            members = _groups(shape, axes, rank)
            xs = [bodies.shardlib_x(m) for m in members]
            assert r["index", k] == list(members).index(rank)
            assert r["size", k] == len(members)
            np.testing.assert_array_equal(r["psum", k], np.sum(xs, axis=0))
            np.testing.assert_array_equal(r["pmax", k], np.max(xs, axis=0))
            np.testing.assert_array_equal(r["pmin", k], np.min(xs, axis=0))
            np.testing.assert_array_equal(r["gather0", k],
                                          np.concatenate(xs, axis=0))
            np.testing.assert_array_equal(r["gather1", k],
                                          np.concatenate(xs, axis=1))
            n = len(members)
            total = sum(np.arange(4 * n, dtype=np.float32) * (m + 1)
                        for m in members)
            i = r["index", k]
            np.testing.assert_array_equal(r["scatter", k],
                                          total[4 * i:4 * i + 4])
            assert r["identity"] and r["bad_spec"]
            # "nodes" would reuse both dims: dropped, then trimmed
            assert r["spec"] == ("data", "model")


@pytest.mark.parametrize("axes", bodies.AXES, ids="+".join)
def test_collective_backward_matches_numpy(world, axes):
    """The gradient through each autograd collective: ``all_gather``'s
    is the ``psum_scatter`` of the ranks' cotangents, ``psum_scatter``'s
    their ``all_gather``, ``psum``'s the rank's own cotangent, and
    ``enter``'s their sum; each backward in a thread that sees no axis
    rules, one of them recomputing a checkpointed gather."""
    w, outs = world
    k = "+".join(axes)
    for shape in bodies.SHARDLIB_MESHES[w]:
        for rank, out in enumerate(outs):
            r = out[shape]
            members = list(_groups(shape, axes, rank))
            n, i = len(members), members.index(rank)
            x = bodies.shardlib_x(rank)
            for name, axis in (("gather0", 0), ("gather1", 1)):
                y = list(x.shape)
                y[axis] *= n
                total = sum(bodies.shardlib_cot(m, tuple(y))
                            for m in members)
                want = np.split(total, n, axis=axis)[i]
                np.testing.assert_array_equal(r["bwd", name, k], want)
                if axis == 0:       # recomputed, then differentiated
                    np.testing.assert_array_equal(r["bwd", "ckpt", k],
                                                  2 * want)
            want = sum((j + 1) * bodies.shardlib_cot(m, (x.size,))
                       for j, m in enumerate(members)).reshape(x.shape)
            np.testing.assert_array_equal(r["bwd", "scatter", k], want)
            np.testing.assert_array_equal(
                r["bwd", "psum", k], bodies.shardlib_cot(rank, x.shape))
            np.testing.assert_array_equal(
                r["bwd", "enter", k],
                sum(bodies.shardlib_cot(m, x.shape) for m in members))


def test_blocks_and_their_gather(world):
    w, outs = world
    g = np.arange(4 * 12, dtype=np.float32).reshape(4, 12)
    for shape in bodies.SHARDLIB_MESHES[w]:
        dp, mp = shape
        for rank, out in enumerate(outs):
            r = out[shape]
            d, m = divmod(rank, mp)
            specs = list(dict.fromkeys(k[1] for k in r
                                       if k[0] == "block"))
            for spec in specs:
                np.testing.assert_array_equal(r["roundtrip", spec], g)
            want = {("data", "model"): g[d * 4 // dp:(d + 1) * 4 // dp,
                                         m * 12 // mp:(m + 1) * 12 // mp]}
            i = d * mp + m                      # row-major (data, model)
            want[(None, ("data", "model"))] = g[:, i * 12 // w:
                                                (i + 1) * 12 // w]
            j = m * dp + d                      # row-major (model, data)
            want[(None, ("model", "data"))] = g[:, j * 12 // w:
                                                (j + 1) * 12 // w]
            for spec in specs:
                np.testing.assert_array_equal(r["block", spec],
                                              want[tuple(spec)])


@pytest.mark.parametrize("n", [2, 3])
def test_surviving_mesh(spawned, n):
    """n survivors of 4 ranks at model parallelism 2 re-form (1, 2) over
    ranks 0 and 1 (the rest idle); 1 survivor cannot hold a shard."""
    spawned = spawned.results()
    assert spawned[0]["surv", n] == ((1, 2), (0, 0), 1.0)
    assert spawned[1]["surv", n] == ((1, 2), (0, 1), 1.0)
    assert all(out["surv", n] is None for out in spawned[2:])
    for out in spawned:
        assert "not enough devices" in out["surv_one"]


def test_compressed_mean_across_ranks(world):
    w, outs = world
    grads = [_grads(r) for r in range(w)]
    noise = [_noise(r) for r in range(w)]
    for k in grads[0]:
        mean = np.sum([g[k] for g in grads], axis=0) / np.float32(w)
        deq = []
        for g, nz in zip(grads, noise):
            q, s = quantize_int8(torch.from_numpy(g[k]),
                                 torch.from_numpy(nz[k]))
            deq.append(dequantize_int8(q, s).numpy())
        step = min(np.abs(g[k]).max() / 127.0 for g in grads)
        for out in outs:
            np.testing.assert_array_equal(out["none"][k], mean)
            err = np.abs(out["int8"][k] - np.mean(deq, axis=0)).max()
            assert err <= step, (k, err, step)
