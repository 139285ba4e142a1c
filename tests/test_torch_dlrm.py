"""The port's DLRM serving path against the JAX package's, with the JAX
weights carried across by ``models/convert.py``.

The forward pass is f32 on both sides; the logits agree to rtol 1e-5
with atol 1e-6: the two packages sum their f32 matmuls in other orders,
which moves a logit by ~1e-7, more than 1e-5 of it only where the logit
is near zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dlrm_rm2 as jax_rm2
from repro.models import dlrm as jd
from repro_torch.configs import dlrm_rm2
from repro_torch.models import dlrm as td
from repro_torch.models.convert import dlrm_params_from_numpy

KEY = jax.random.PRNGKey(0)


def _pair(vocab):
    jcfg = jd.DLRMConfig(vocab_per_table=vocab)
    tcfg = td.DLRMConfig(vocab_per_table=vocab)
    jp = jd.init_params(KEY, jcfg)
    tp = dlrm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module", params=[500, "smoke"])
def models(request):
    if request.param == "smoke":
        assert dlrm_rm2.smoke_config().vocab_per_table == \
            jax_rm2.smoke_config().vocab_per_table
        return _pair(dlrm_rm2.smoke_config().vocab_per_table)
    return _pair(request.param)


def test_forward_matches_jax(models):
    jcfg, tcfg, jp, tp = models
    rng = np.random.default_rng(tcfg.vocab_per_table)
    dense = rng.normal(size=(64, 13)).astype(np.float32)
    sparse = rng.integers(0, tcfg.vocab_per_table, (64, 26)).astype(np.int32)
    want = np.asarray(jd.forward(jp, jnp.asarray(dense), jnp.asarray(sparse),
                                 jcfg))
    got = td.forward(tp, torch.from_numpy(dense), torch.from_numpy(sparse),
                     tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_retrieval_top10_matches_jax(models):
    jcfg, tcfg, jp, tp = models
    rng = np.random.default_rng(7)
    dense = rng.normal(size=(1, 13)).astype(np.float32)
    sparse = rng.integers(0, tcfg.vocab_per_table, (1, 26)).astype(np.int32)
    cand = np.arange(tcfg.vocab_per_table, dtype=np.int32)
    jv, ji = jd.retrieval_scores(jp, jnp.asarray(dense), jnp.asarray(sparse),
                                 jnp.asarray(cand), jcfg, top_k=10)
    tv, ti = td.retrieval_scores(tp, torch.from_numpy(dense),
                                 torch.from_numpy(sparse),
                                 torch.from_numpy(cand), tcfg, top_k=10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-6)


def test_embedding_bag_hand_case_and_jax():
    """``tests/test_models.py``'s hand case, in both modes, and against
    the JAX ``embedding_bag`` (f32 sums of at most 3 rows: rtol 1e-6)."""
    rng = np.random.default_rng(0)
    tab = rng.normal(size=(50, 8)).astype(np.float32)
    ids = np.array([3, 4, 7, 1, 1, 2], np.int32)
    offs = np.array([0, 2, 5, 6], np.int32)
    ref = np.stack([tab[3] + tab[4], tab[7] + 2 * tab[1], tab[2]])
    for mode, div in (("sum", 1.0), ("mean", np.array([[2.], [3.], [1.]]))):
        got = td.embedding_bag(torch.from_numpy(tab), torch.from_numpy(ids),
                               torch.from_numpy(offs), 3, mode=mode).numpy()
        np.testing.assert_allclose(got, ref / div, rtol=1e-6)
        np.testing.assert_allclose(got, np.asarray(jd.embedding_bag(
            jnp.asarray(tab), jnp.asarray(ids), jnp.asarray(offs), 3,
            mode=mode)), rtol=1e-6)
    empty = td.embedding_bag(torch.from_numpy(tab), torch.from_numpy(ids),
                             torch.tensor([0, 0, 6]), 2).numpy()
    np.testing.assert_array_equal(empty[0], np.zeros(8, np.float32))
    with pytest.raises(ValueError, match="mode"):
        td.embedding_bag(torch.from_numpy(tab), torch.from_numpy(ids),
                         torch.from_numpy(offs), 3, mode="max")


def test_embedding_lookup_matches_jax_out_of_range():
    """Ids outside [0, V) (negative too) give zero rows, as the JAX
    lookup's range mask does; in-range rows are copied exactly."""
    rng = np.random.default_rng(2)
    tables = rng.normal(size=(3, 10, 8)).astype(np.float32)
    ids = rng.integers(0, 10, (5, 3)).astype(np.int32)
    ids[0] = [-1, 10, 9]
    ids[1] = [0, -10, 25]
    got = td.embedding_lookup(torch.from_numpy(tables),
                              torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jd.embedding_lookup(
        jnp.asarray(tables), jnp.asarray(ids))))
    np.testing.assert_array_equal(got[0, 2], tables[2, 9])
    assert not got[0, :2].any() and not got[1, 1:].any()


def test_param_count_and_init_law():
    assert dlrm_rm2.CONFIG.param_count() == jax_rm2.CONFIG.param_count()
    cfg = td.DLRMConfig(vocab_per_table=200)
    p = td.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    assert p["tables"].shape == (26, 200, 64)
    assert p["tables"].abs().max() <= 200 ** -0.5
    assert [tuple(w.shape) for w, _ in p["top"]] == \
        [(415, 512), (512, 512), (512, 256), (256, 1)]
    assert not any(b.any() for _, b in p["bot"] + p["top"])


def test_config_refuses_an_interaction_it_does_not_port():
    """forward computes the dot interaction only, so the config refuses
    any other rather than silently ignoring it."""
    assert dlrm_rm2.CONFIG.interaction == "dot"
    with pytest.raises(ValueError, match="dot interaction"):
        td.DLRMConfig(interaction="cat")
