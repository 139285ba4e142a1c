"""The port's closeness application against the JAX package's, with the
index read from a raw store (bounded sweeps):
``tests/closeness_support.py`` holds the cases' checks."""
import pytest

import closeness_support as cs
import torchdist

WHERE = "raw"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with torchdist.one_thread():
        yield


@pytest.fixture(scope="module")
def fixture_ix(tmp_path_factory):
    return cs.build(tmp_path_factory.mktemp("closeness"), ("raw",))


@pytest.mark.parametrize("graph", cs.GRAPHS)
@pytest.mark.parametrize("eps, batch, k_override", cs.ESTIMATE_CASES)
def test_estimate_closeness_matches_jax(fixture_ix, graph, eps, batch,
                                        k_override):
    cs.check_estimate(fixture_ix, graph, WHERE, eps, batch, k_override)


@pytest.mark.parametrize("graph", cs.GRAPHS)
@pytest.mark.parametrize("k, batch, n_cand", cs.TOPK_CASES)
def test_topk_closeness_matches_jax(fixture_ix, graph, k, batch, n_cand):
    cs.check_topk(fixture_ix, graph, WHERE, k, batch, n_cand)


@pytest.mark.parametrize("where", [WHERE])
def test_topk_from_the_store_equals_memory_and_prunes(fixture_ix, where):
    cs.check_store_prunes(fixture_ix, where)
