"""The port's MoE block (``models/layers.py::moe_block``) against the JAX
package's, on the same seeded numpy inputs, on the CPU.

* Routing: each token's top-k expert ids equal JAX's ``lax.top_k`` ids
  (the smallest gap between a token's k-th and (k+1)-th probability is
  in the assert message: a gap near f32 rounding could flip a choice).
* bf16 (the serving dtype): the output bit for bit.  The port gathers
  each token's k expert rows and adds them left to right in ascending
  expert order, rounding after each add, which is the order XLA's CPU
  scatter-add meets them in; the expert products round once to bf16 in
  both packages.
* f32: the output within atol 1e-5 (the GEMMs sum in another order;
  measured up to 1.5e-6 here), the aux loss within 1e-6, and the
  gradients of ``sum(y * g) + aux`` within rtol 1e-4 and an atol of
  1e-6 of each gradient's largest magnitude (the leaves reach ~30 here;
  an element that cancels keeps the absolute error of its summands'
  scale: measured 2.8e-6 on a router element of 9e-3).
* Each case runs at capacity factors 1.25 (the published one), 0.5
  (drops: the drop count is checked against a count made in numpy) and
  E / k (no drops).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

B, S, D, E, K, F = 2, 64, 64, 8, 2, 32
CAPACITY = {"cf1.25": 1.25, "cf0.5": 0.5, "nodrop": E / K}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, D)).astype(np.float32),
            (rng.normal(size=(D, E)) * 0.3).astype(np.float32),
            (rng.normal(size=(E, D, F)) / 8).astype(np.float32),
            (rng.normal(size=(E, D, F)) / 8).astype(np.float32),
            (rng.normal(size=(E, F, D)) / 6).astype(np.float32)]


def _pair(arrays, jdt, tdt):
    ja = [jnp.asarray(a).astype(jdt) for a in arrays]
    ta = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
          for a in ja]
    return ja, ta


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cap", list(CAPACITY))
def test_moe_block_matches_jax(cap, dtype):
    jdt, tdt = DTYPES[dtype]
    cf = CAPACITY[cap]
    jcfg = jl.MoEConfig(E, K, F, capacity_factor=cf)
    tcfg = tl.MoEConfig(E, K, F, capacity_factor=cf)
    ja, ta = _pair(_inputs(), jdt, tdt)
    jy, jaux = jl.moe_block(*ja, jcfg)
    ty, taux = tl.moe_block(*ta, tcfg)

    xt = ta[0].reshape(-1, D)
    route = tl.moe_route(xt, ta[1], tcfg)
    probs = jax.nn.softmax(ja[0].reshape(-1, D).astype(jnp.float32)
                           @ ja[1].astype(jnp.float32), axis=-1)
    top, jid = jax.lax.top_k(probs, K + 1)
    margin = float((top[:, K - 1] - top[:, K]).min())
    np.testing.assert_array_equal(
        route.expert.numpy(), np.sort(np.asarray(jid[:, :K]), axis=-1),
        err_msg=f"top-k ids differ; smallest k/k+1 margin {margin:.3e}")

    # drops: past the capacity in each expert's queue (token order)
    ids = np.sort(np.asarray(jid[:, :K]), axis=-1).reshape(-1)
    counts = np.bincount(ids, minlength=E)
    assert route.cap == max(8, -(-int(np.ceil(B * S * K * cf / E)) // 8) * 8)
    dropped = int((~route.keep).sum())
    assert dropped == int(np.maximum(counts - route.cap, 0).sum())
    assert (dropped > 0) == (cap == "cf0.5")
    slot = route.slot.numpy()
    assert (slot[~route.keep.numpy()] == E * route.cap).all()
    kept = slot[route.keep.numpy()]
    assert len(np.unique(kept)) == len(kept)              # one row each

    assert ty.dtype == tdt and ty.shape == (B, S, D)
    if dtype == "bf16":
        np.testing.assert_array_equal(ty.float().numpy(), _np(jy))
    else:
        np.testing.assert_allclose(ty.numpy(), _np(jy), atol=1e-5, rtol=0)
        np.testing.assert_allclose(taux.item(), float(jaux), atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("cap", list(CAPACITY))
def test_moe_block_grads_match_jax(cap):
    """f32 gradients of ``sum(y * g) + aux`` with respect to x and every
    weight, against ``jax.grad`` (the router's through the gates and
    the aux loss; dropped choices give none)."""
    cf = CAPACITY[cap]
    jcfg = jl.MoEConfig(E, K, F, capacity_factor=cf)
    tcfg = tl.MoEConfig(E, K, F, capacity_factor=cf)
    arrays = _inputs(1)
    g = np.random.default_rng(2).normal(size=(B, S, D)).astype(np.float32)

    def jloss(*a):
        y, aux = jl.moe_block(*a, jcfg)
        return jnp.sum(y * g) + aux
    want = jax.grad(jloss, argnums=tuple(range(5)))(
        *[jnp.asarray(a) for a in arrays])
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    y, aux = tl.moe_block(*ts, tcfg)
    got = torch.autograd.grad((y * torch.from_numpy(g)).sum() + aux, ts)
    for name, gt, w in zip(("x", "router", "wg", "wu", "wd"), got, want):
        w = _np(w)
        np.testing.assert_allclose(gt.numpy(), w, rtol=1e-4,
                                   atol=1e-6 * np.abs(w).max(), err_msg=name)


def test_moe_capacity_and_counts():
    """The capacity formula at the published configs' decode and train
    token counts."""
    granite = tl.MoEConfig(n_experts=32, top_k=8, d_ff=512)
    qwen = tl.MoEConfig(n_experts=128, top_k=8, d_ff=768)
    for cfg in (granite, qwen):
        jcfg = jl.MoEConfig(cfg.n_experts, cfg.top_k, cfg.d_ff)
        for t in (1, 8, 32, 4096, 4097):
            want = int(-(-t * jcfg.top_k * jcfg.capacity_factor
                         // jcfg.n_experts))
            assert tl.moe_capacity(t, cfg) == max(8, -(-want // 8) * 8)
    assert tl.moe_capacity(4096, granite) == 1280
    assert tl.moe_capacity(32, granite) == 16
    assert tl.moe_capacity(8, qwen) == 8
