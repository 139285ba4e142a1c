"""The port's op analyzer (``repro_torch.launch.op_analysis``) against the
JAX package's HLO analyzer: the counterparts of the five tests of
``tests/test_hlo_analysis.py``.  Each function runs through both, and
the FLOPs are held equal to rtol 1e-3, as the JAX tests hold theirs to
the closed form.  Eager runs every loop trip, so a Python loop here is
the counterpart of a ``lax.scan`` there."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.launch.hlo_analysis import analyze as hlo_analyze
from repro_torch.launch.op_analysis import BYTE_CLASSES, COLLECTIVES, analyze

ROOT = Path(__file__).resolve().parent.parent


def _hlo(f, *shapes):
    sds = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return hlo_analyze(jax.jit(f).lower(*sds).compile().as_text())


def _randn(*shape):
    return torch.from_numpy(np.random.default_rng(0).standard_normal(
        shape).astype(np.float32))


def _close(got, want):
    assert abs(got - want) / want < 1e-3, (got, want)


def test_loop_flops_counted_every_trip():
    m = 128

    def jf(x):
        def body(c, _):
            return c @ x, None
        out, _ = jax.lax.scan(body, x, None, length=10)
        return out

    def tf(x):
        c = x
        for _ in range(10):
            c = c @ x
        return c
    r = analyze(tf, _randn(m, m))
    assert r["flops"] == 10 * 2 * m ** 3
    _close(r["flops"], _hlo(jf, (m, m))["flops"])


def test_nested_loops_multiply():
    m = 64

    def jf(x):
        def inner(c, _):
            return c @ x, None

        def outer(c, _):
            c2, _ = jax.lax.scan(inner, c, None, length=3)
            return c2, None
        out, _ = jax.lax.scan(outer, x, None, length=5)
        return out

    def tf(x):
        c = x
        for _ in range(5):
            for _ in range(3):
                c = c @ x
        return c
    r = analyze(tf, _randn(m, m))
    assert r["flops"] == 15 * 2 * m ** 3
    _close(r["flops"], _hlo(jf, (m, m))["flops"])


# the torch side of the collectives test: rank 0 of a fake group of 4,
# psum over the mesh's one axis (the port's shardlib), 7 trips
_COLLECTIVE_BODY = """
import json, sys
import numpy as np, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch import shardlib as sl
from repro_torch.launch.op_analysis import analyze
m = 128
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
try:
    mesh = sl.make_mesh((4,), ("x",), "cpu")
    with sl.axis_rules(mesh, {"x": "x"}):
        def f(x):
            c = x
            for _ in range(7):
                c = sl.psum(c, ("x",)) + c @ x
            return c
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (m, m)).astype(np.float32))
        r = analyze(f, x)
finally:
    dist.destroy_process_group()
json.dump(r, sys.stdout)
"""


def test_collectives_in_loops_counted():
    m = 128
    out = subprocess.run(
        [sys.executable, "-c", _COLLECTIVE_BODY], capture_output=True,
        text=True, timeout=120, cwd=str(ROOT),
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout)
    assert r["collectives"]["all-reduce"] == 7 * m * m * 4
    assert r["collective_bytes"] == 7 * m * m * 4
    assert set(r["collectives"]) == set(COLLECTIVES)
    mesh = jax.make_mesh((1,), ("x",))

    def jf(x):
        def body(c, _):
            return jax.lax.psum(c, "x") + c @ x, None
        out, _ = jax.lax.scan(body, x, None, length=7)
        return out

    from repro.shardlib import _SHARD_MAP_KW, _shard_map
    with mesh:
        g = _shard_map(jf, mesh=mesh, in_specs=jax.sharding.PartitionSpec(),
                       out_specs=jax.sharding.PartitionSpec(),
                       **_SHARD_MAP_KW)
        want = hlo_analyze(jax.jit(g).lower(
            jax.ShapeDtypeStruct((m, m), jnp.float32)).compile().as_text())
    assert r["collectives"]["all-reduce"] == want["collectives"]["all-reduce"]
    _close(r["flops"], want["flops"])


def test_dot_flops_with_batch_dims():
    b, m, k, n = 4, 32, 48, 16

    def jf(x, y):
        return jnp.einsum("bmk,bkn->bmn", x, y)
    r = analyze(lambda x, y: torch.einsum("bmk,bkn->bmn", x, y),
                _randn(b, m, k), _randn(b, k, n))
    assert r["flops"] == r["matmul_flops"] == 2 * b * m * k * n
    _close(r["flops"], _hlo(jf, (b, m, k), (b, k, n))["flops"])


def test_bytes_by_class_present():
    r = analyze(lambda x: torch.relu(x @ x), _randn(64, 64))
    assert set(r["bytes_by_class"]) == set(BYTE_CLASSES) == {
        "dot", "elementwise", "gather_scatter", "copy_layout", "collective",
        "other"}
    assert r["bytes_by_class"]["dot"] > 0
    # the product: two operands and the result; relu: one in, one out
    assert r["bytes_by_class"]["dot"] == 3 * 64 * 64 * 4
    assert r["bytes_by_class"]["elementwise"] == 2 * 64 * 64 * 4
    assert r["bytes"] == sum(r["bytes_by_class"].values())
    _close(r["flops"], _hlo(lambda x: jax.nn.relu(x @ x), (64, 64))["flops"])
