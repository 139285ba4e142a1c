"""The port's serving cells: each smoke cell runs on the CPU end to end,
and the model FLOPs match the JAX cell builder's formula."""
import pytest
import torch

from repro.launch import steps as jax_steps
from repro_torch.configs import glm4_9b
from repro_torch.launch.steps import _dlrm_flops, _lm_flops, build_cell


@pytest.mark.parametrize("arch,shape", [
    ("glm4-9b", "decode_32k"), ("glm4-9b", "prefill_32k"),
    ("dlrm-rm2", "serve_p99"), ("dlrm-rm2", "retrieval_cand")])
def test_smoke_cells_run_on_the_cpu(arch, shape):
    cell = build_cell(arch, shape, smoke=True, device="cpu")
    assert cell.kind in ("decode", "prefill", "serve", "retrieval")
    assert cell.model_flops > 0
    out = cell.run()
    if cell.kind == "decode":
        logits, caches = out
        cfg = cell.meta["cfg"]
        assert logits.shape == (2, cfg.vocab) and logits.dtype == torch.float32
        # the step wrote the new K/V at slot cur_len = 127, in place
        assert caches is cell.args[1] and caches[0]["k"][:, :, 127].any()
    elif cell.kind == "prefill":
        logits, caches = out
        assert logits.shape == (2, cell.meta["cfg"].vocab)
        assert caches[0]["k"].shape == (2, 2, 64, 2, 16)
    elif cell.kind == "serve":
        assert out.shape == (8,)
    else:
        vals, ids = out
        assert vals.shape == ids.shape == (128,)
        assert (vals[:-1] >= vals[1:]).all()
    first = out[0] if isinstance(out, tuple) else out
    assert torch.isfinite(first).all()


def test_flops_match_the_jax_builder():
    for shape in ("prefill_32k", "decode_32k", "train_4k"):
        sp = jax_steps.SHAPE_PARAMS["lm"][shape]
        assert _lm_flops(glm4_9b.CONFIG, sp["kind"], sp["global_batch"],
                         sp["seq_len"]) == \
            jax_steps.model_flops_for("glm4-9b", shape)
    from repro_torch.configs import dlrm_rm2
    for shape, n in (("serve_p99", 0), ("serve_bulk", 0),
                     ("retrieval_cand", 1_000_192)):
        sp = jax_steps.SHAPE_PARAMS["recsys"][shape]
        assert _dlrm_flops(dlrm_rm2.CONFIG, sp["kind"], sp.get("batch", 1),
                           n) == jax_steps.model_flops_for("dlrm-rm2", shape)


def test_cells_refuse_what_they_do_not_serve():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_cell("glm4-9b", "train_4k", smoke=True, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_cell("dlrm-rm2", "train_batch", smoke=True, device="cpu")
    with pytest.raises(ValueError, match="full-attention"):
        build_cell("glm4-9b", "long_500k", smoke=True, device="cpu")
    with pytest.raises(KeyError, match="unknown arch"):
        build_cell("gemma3-12b", "decode_32k", smoke=True, device="cpu")


def test_batch_cut_is_recorded():
    cell = build_cell("dlrm-rm2", "serve_p99", smoke=True, device="cpu",
                      batch=3)
    assert cell.meta["reduced"] == {"batch": [8, 3]}
    assert cell.run().shape == (3,)
    assert "reduced" not in build_cell("dlrm-rm2", "serve_p99", smoke=True,
                                       device="cpu").meta
