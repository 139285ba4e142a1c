"""The port's optimizer against the JAX package's, on the same numpy
inputs: ``adamw_update`` (in place in the port), ``clip_by_global_norm``,
the weight-decay mask and the schedules.

Tolerance rtol 1e-6 (atol 1e-7 near zero): the two run the same f32
operations in the same order; the global norm's sum and ``pow`` of the
bias corrections may round their last bit differently.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadam
from repro.optim import schedules as jsched
from repro_torch.optim import (OptState, adamw_init, adamw_update,
                               clip_by_global_norm, cosine_schedule,
                               linear_warmup)
from repro_torch.optim import adamw as tadam
from repro_torch.tree import leaves

TOL = dict(rtol=1e-6, atol=1e-7)


def _trees(seed):
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(6, 5)).astype(np.float32),
              "layers": [{"a": rng.normal(size=(3, 4, 2)).astype(np.float32),
                          "scale": rng.normal(size=(7,)).astype(np.float32)}],
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = {"w": rng.normal(size=(6, 5)).astype(np.float32) * 3,
             "layers": [{"a": rng.normal(size=(3, 4, 2)).astype(np.float32),
                         "scale": rng.normal(size=(7,)).astype(np.float32)}],
             "b": rng.normal(size=(5,)).astype(np.float32) * 1e-3}
    return params, grads


def _j(tree):
    import jax
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    import jax
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_tree_close(got, want, **tol):
    import jax
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


@pytest.mark.parametrize("chunk", [None, 7])
@pytest.mark.parametrize("max_norm,wd,lr", [(1.0, 0.1, 3e-2), (1e6, 0.0, 1e-3),
                                            (100.0, 0.5, "schedule")])
def test_adamw_update_matches_jax(monkeypatch, chunk, max_norm, wd, lr):
    """Four steps from the same state, with a clip that binds and two
    that do not; ``chunk`` forces the in-place passes to slice every leaf
    (as they slice a 6.66 GB table)."""
    if chunk is not None:
        monkeypatch.setattr(tadam, "_CHUNK", chunk)
    params, grads = _trees(1)
    jp, jopt = _j(params), jadam.adamw_init(_j(params))
    tp = _t(params)
    topt = adamw_init(tp)
    for step in range(4):
        scale = 1.0 + step
        g_np = {"w": grads["w"] * scale, "b": grads["b"] * scale,
                "layers": [{k: a * scale for k, a in grads["layers"][0].items()}]}
        if lr == "schedule":
            jlr = jsched.cosine_schedule(jopt.count, 0.1, 2, 10)
            tlr = cosine_schedule(topt.count, 0.1, 2, 10)
        else:
            jlr = tlr = lr
        jp, jopt, jgn = jadam.adamw_update(jp, _j(g_np), jopt, jlr,
                                           weight_decay=wd,
                                           max_grad_norm=max_norm)
        tp_out, topt, tgn = adamw_update(tp, _t(g_np), topt, tlr,
                                         weight_decay=wd,
                                         max_grad_norm=max_norm)
        assert tp_out is tp                     # in place
        np.testing.assert_allclose(tgn.item(), float(jgn), rtol=1e-6)
    assert isinstance(topt, OptState) and int(topt.count) == 4
    assert topt.count.dtype == torch.int32
    _assert_tree_close(tp, jp, **TOL)
    _assert_tree_close(topt.m, jopt.m, **TOL)
    _assert_tree_close(topt.v, jopt.v, **TOL)


def test_clip_by_global_norm_matches_jax():
    _, grads = _trees(2)
    jc, jgn = jadam.clip_by_global_norm(_j(grads), 1.0)
    tg = _t(grads)
    tc, tgn = clip_by_global_norm(tg, 1.0)
    np.testing.assert_allclose(tgn.item(), float(jgn), rtol=1e-6)
    _assert_tree_close(tc, jc, **TOL)
    # the JAX test's hand case: norm 10 clipped to 1
    g = {"a": torch.full((4,), 3.0), "b": torch.full((4,), 4.0)}
    clipped, gn = clip_by_global_norm(g, 1.0)
    assert np.isclose(gn.item(), 10.0)
    assert np.isclose(np.sqrt(sum(float((x ** 2).sum())
                                  for x in leaves(clipped))), 1.0, rtol=1e-5)


def test_weight_decay_mask_matches_jax():
    """Decay reaches ``ndim >= 2`` leaves only; zero gradients, so only
    the decay moves a parameter."""
    params = {"w": np.ones((2, 2), np.float32),
              "scale": np.ones((2,), np.float32)}
    zeros = {k: np.zeros_like(v) for k, v in params.items()}
    jp, _, _ = jadam.adamw_update(_j(params), _j(zeros),
                                  jadam.adamw_init(_j(params)), 1.0,
                                  weight_decay=0.5)
    tp = _t(params)
    adamw_update(tp, _t(zeros), adamw_init(tp), 1.0, weight_decay=0.5)
    _assert_tree_close(tp, jp, rtol=0, atol=0)
    assert tp["w"][0, 0] < 1.0 and tp["scale"][0] == 1.0


def test_schedules_match_jax():
    for step in [0, 1, 5, 9, 10, 11, 50, 99, 100, 150]:
        for warm, total in ((10, 100), (0, 7), (2000, 200_000)):
            j = jsched.cosine_schedule(jnp.int32(step), 3e-4, warm, total)
            t = cosine_schedule(torch.tensor(step, dtype=torch.int32), 3e-4,
                                warm, total)
            np.testing.assert_allclose(t.item(), float(j), rtol=1e-6,
                                       atol=1e-12)
        np.testing.assert_allclose(
            linear_warmup(torch.tensor(step), 1.0, 10).item(),
            float(jsched.linear_warmup(jnp.int32(step), 1.0, 10)), rtol=1e-6)
    # the JAX test's shape
    s = lambda n: cosine_schedule(torch.tensor(n), 1.0, 10, 100).item()  # noqa: E731
    assert s(0) == 0.0 and s(10) > 0.9 and s(100) <= 0.11


def test_adamw_converges_quadratic():
    """The JAX test's quadratic, through autograd."""
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    opt = adamw_init(params)
    for _ in range(200):
        w = params["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(((w - target) ** 2).sum(), [w])
        _, opt, _ = adamw_update(params, {"w": g}, opt, 5e-2,
                                 weight_decay=0.0)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=1e-2)


def test_an_update_keeps_no_gradient_alive():
    """With the cyclic garbage collector off, a gradient tree dropped
    after ``adamw_update`` frees its tensors at once: the tree helpers
    form no reference cycle (a cycle kept each step's 6.66 GB table
    gradient of rm2 alive until a collection, 47.8 GB at peak on the
    card against 27.8 GB)."""
    import gc
    import weakref

    from repro_torch.tree import flatten_with_paths, map_tree, unflatten
    params, grads = _trees(3)
    tp = _t(params)
    opt = adamw_init(tp)
    gc.collect()
    gc.disable()
    try:
        tg = _t(grads)
        refs = [weakref.ref(g) for g in leaves(tg)]
        flatten_with_paths(tg)
        unflatten(tg, leaves(tg))
        map_tree(lambda g: g, tg)
        adamw_update(tp, tg, opt, 1e-3)
        del tg
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
