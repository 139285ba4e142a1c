"""The port's kernel modules against the JAX package's kernels.

On the CPU the port's wrappers run their plain versions; these are held
bit-exactly (``assert_array_equal``) against the JAX ``ref`` functions
and the Pallas kernels in interpret mode: every operation is an fp32
add or a min, which give the same bits in any order.  The port's label
state is node-major (``[N, S]``), the JAX package's ``[S, N]``: the
comparisons transpose.  The CUDA kernels themselves run only on a card:
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import io
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core.build_fast import build_hod_fast as jax_build_hod_fast
from repro.kernels.edge_relax.ops import relax_bucketed as jax_relax_bucketed
from repro.kernels.edge_relax.ref import relax_bucketed_ref as jax_relax_ref
from repro.kernels.tropical_matmul.ops import minplus as jax_minplus
from repro.kernels.tropical_matmul.ref import minplus_ref as jax_minplus_ref
from repro_torch.core.query import _plan_sweep
from repro_torch.kernels.edge_relax import (pack_sweep, relax_bucketed_ref,
                                            relax_sweep_)
from repro_torch.kernels.tropical_matmul import minplus, minplus_ref
from torchsupport import plan_like_level, t as _t

MINPLUS_SHAPES = [(1, 1, 1), (4, 7, 9), (8, 128, 128), (64, 130, 257),
                  (128, 128, 384), (33, 65, 5)]
RELAX_SHAPES = [(1, 10, 3, 1), (4, 100, 37, 5), (8, 300, 128, 9),
                (3, 64, 200, 2)]


# ---------------------------------------------------------------- tropical
@pytest.mark.parametrize("m,k,n", MINPLUS_SHAPES)
def test_minplus_matches_jax(m, k, n):
    rng = np.random.default_rng(m * 1000 + k)
    a = rng.uniform(0, 10, (m, k)).astype(np.float32)
    b = rng.uniform(0, 10, (k, n)).astype(np.float32)
    a[0, 0] = np.inf                      # unreachable: absorbing
    b[rng.random((k, n)) < 0.1] = np.inf
    got = minplus(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_minplus_ref(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(
        got, np.asarray(jax_minplus(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(
        minplus_ref(_t(a), _t(b), block_k=3).numpy(), got)


def test_minplus_strided_rows():
    """``a`` may be a column slice (the core block of the label state)."""
    rng = np.random.default_rng(1)
    wide = rng.uniform(0, 10, (6, 40)).astype(np.float32)
    b = rng.uniform(0, 10, (25, 11)).astype(np.float32)
    got = minplus(_t(wide)[:, 5:30], _t(b)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_minplus_ref(jnp.asarray(wide[:, 5:30]),
                                        jnp.asarray(b))))


# --------------------------------------------------------------- edge_relax
def _relax_inputs(s, n, m, k, seed):
    rng = np.random.default_rng(seed)
    dist = rng.uniform(0, 10, (s, n)).astype(np.float32)
    src = rng.integers(0, n, (m, k)).astype(np.int32)
    w = rng.uniform(0, 3, (m, k)).astype(np.float32)
    if k > 1:  # padding lanes
        w[:, -1] = np.inf
    cur = rng.uniform(0, 20, (s, m)).astype(np.float32)
    return rng, dist, src, w, cur


@pytest.mark.parametrize("s,n,m,k", RELAX_SHAPES)
def test_relax_bucketed_matches_jax(s, n, m, k):
    _, dist, src, w, cur = _relax_inputs(s, n, m, k, seed=s * 31 + m)
    gathered = dist[:, src.reshape(-1)].reshape(s, m, k)
    got = relax_bucketed_ref(_t(gathered), _t(w), _t(cur)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_relax_ref(jnp.asarray(gathered), jnp.asarray(w),
                                      jnp.asarray(cur))))
    for use_pallas in (False, True):
        np.testing.assert_array_equal(got, np.asarray(jax_relax_bucketed(
            jnp.asarray(dist), jnp.asarray(src), jnp.asarray(w),
            jnp.asarray(cur), use_pallas=use_pallas)))


@pytest.mark.parametrize("s,n,m,k", [(4, 100, 37, 5), (3, 64, 200, 2)])
def test_relax_bucketed_row_validity_mask(s, n, m, k):
    """Masked (padding) rows pass ``cur`` through untouched, even when
    they would win (zero weights)."""
    rng, dist, src, w, cur = _relax_inputs(s, n, m, k, seed=m)
    w[0] = 0.0
    valid = rng.random(m) < 0.6
    valid[0] = False
    gathered = dist[:, src.reshape(-1)].reshape(s, m, k)
    got = relax_bucketed_ref(_t(gathered), _t(w), _t(cur),
                             _t(valid)).numpy()
    for use_pallas in (False, True):
        np.testing.assert_array_equal(got, np.asarray(jax_relax_bucketed(
            jnp.asarray(dist), jnp.asarray(src), jnp.asarray(w),
            jnp.asarray(cur), row_valid=jnp.asarray(valid),
            use_pallas=use_pallas)))
    np.testing.assert_array_equal(got[:, ~valid], cur[:, ~valid])


@pytest.mark.parametrize("s,n,m,k", [(1, 10, 4, 1), (4, 100, 37, 5),
                                     (8, 300, 128, 9), (3, 64, 200, 2),
                                     (33, 500, 96, 16)])
def test_relax_level_matches_jax_gather_scatter(s, n, m, k):
    """One level, packed as a one-level sweep and relaxed in place on the
    node-major state, equals the JAX executor's level body,
    ``dist.at[:, dst].min(relax_bucketed(...))``."""
    dist, dst, src, w, valid = plan_like_level(s, n, m, k, seed=n + m)
    sweep = pack_sweep([(dst, src, w, valid)], n + 1)
    got = relax_sweep_(_t(dist.T), sweep).numpy().T
    jd = jnp.asarray(dist)
    new = jax_relax_bucketed(jd, jnp.asarray(src), jnp.asarray(w),
                             jd[:, dst], row_valid=jnp.asarray(valid),
                             use_pallas=n <= 100)
    want = np.asarray(jd.at[:, dst].min(new))
    np.testing.assert_array_equal(got, want)
    assert np.isinf(got[:, n]).all()
    assert not np.array_equal(got, dist) or m < 8


_SWEEP_INDEXES = {}


def _sweep_index(name):
    """(JAX index, the port's index read from its .npz roster)."""
    if name not in _SWEEP_INDEXES:
        g = (J.grid_road_graph(10, seed=4) if name == "grid10"
             else J.power_law_digraph(200, 3, seed=5, weighted=True))
        res = jax_build_hod_fast(g, J.BuildConfig(max_core_nodes=32,
                                                  max_core_edges=1024))
        ixj = J.pack_index(g, res, chunk=64)
        buf = io.BytesIO()
        ixj.save(buf)
        buf.seek(0)
        with np.load(buf) as z:
            _SWEEP_INDEXES[name] = (ixj, T.index_from_numpy(z))
    return _SWEEP_INDEXES[name]


@pytest.mark.parametrize("name,forward,use_pallas", [
    ("grid10", True, True), ("grid10", False, True),
    ("powerlaw200", True, False), ("powerlaw200", False, False)])
def test_sweep_matches_jax_run_plan(name, forward, use_pallas):
    """A whole packed sweep of a real index, in one ``relax_sweep_``
    call, equals the JAX engine's ``_run_plan`` over the same plan with
    its ``_relax_level`` body (a ``lax.scan`` over every level)."""
    ixj, ixt = _sweep_index(name)
    ej = J.QueryEngine(ixj, use_pallas=use_pallas)
    plan_t = ixt.plan_f if forward else ixt.plan_b
    assert plan_t.n_real_levels > 1
    rng = np.random.default_rng(len(name) + forward)
    dist = rng.integers(0, 40, (6, ixt.n_pad)).astype(np.float32)
    dist[rng.random(dist.shape) < 0.4] = np.inf
    dist[:, ixt.n] = np.inf
    want = np.asarray(ej._run_plan(jnp.asarray(dist),
                                   ej._plan_f if forward else ej._plan_b,
                                   ej._relax_level))
    sweep = _plan_sweep(plan_t, ixt.n_pad, torch.device("cpu"))
    got = relax_sweep_(_t(dist.T), sweep).numpy().T
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, dist)


def test_cpu_tensors_never_launch():
    dist, dst, src, w, valid = plan_like_level(4, 100, 37, 5, seed=0)
    sweep = pack_sweep([(dst, src, w, valid)], 101)
    before = (relax_sweep_.launches, minplus.launches)
    relax_sweep_(_t(dist.T), sweep)
    minplus(_t(dist[:, :20]), _t(np.ones((20, 30), np.float32)))
    assert (relax_sweep_.launches, minplus.launches) == before


def test_wrappers_raise_off_the_cpu_path():
    """A tensor that is neither on the CPU nor a CUDA device gets an
    error, never the plain version."""
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        minplus(torch.empty(2, 3, **meta), torch.empty(3, 4, **meta))
    _, dst, src, w, valid = plan_like_level(2, 10, 4, 1, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        relax_sweep_(torch.empty(11, 2, **meta),
                     pack_sweep([(dst, src, w, valid)], 11))


def test_kernel_modules_import_without_toolchain():
    """Importing the kernel modules builds nothing and needs neither
    nvcc nor triton: kernels build at first launch on a card."""
    code = ("import sys\n"
            "import repro_torch.kernels.edge_relax, "
            "repro_torch.kernels.tropical_matmul\n"
            "from repro_torch.kernels import _build\n"
            "assert not _build._LIBS\n"
            "assert 'triton' not in sys.modules\n")
    env = {"PATH": "/nonexistent", "PYTHONPATH": "src"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(_repo_root()), timeout=120)


def _repo_root():
    from pathlib import Path
    return Path(__file__).resolve().parent.parent
