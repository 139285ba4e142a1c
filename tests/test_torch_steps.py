"""The port's cells: each smoke cell runs on the CPU end to end (train
cells step on, in place, and the train CLI resumes from its
checkpoints), cuts are recorded, and the model FLOPs match the JAX cell
builder's formula."""
import dataclasses

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
    with pytest.raises(ValueError, match="full-attention"):
        build_cell("glm4-9b", "long_500k", smoke=True, device="cpu")
    with pytest.raises(KeyError, match="unknown arch"):
        build_cell("gemma3-12b", "decode_32k", smoke=True, device="cpu")
    with pytest.raises(ValueError, match="LM's depth"):
        build_cell("dlrm-rm2", "train_batch", smoke=True, device="cpu",
                   layers=2)


@pytest.mark.parametrize("arch,shape", [("glm4-9b", "train_4k"),
                                        ("dlrm-rm2", "train_batch")])
def test_train_cells_run_on_the_cpu(arch, shape):
    """Three steps of each smoke train cell: finite losses, the state
    updated in place (the same dict, the count stepping on), and the
    stream's batches shaped as the cell's own."""
    cell = build_cell(arch, shape, smoke=True, device="cpu")
    assert cell.kind == "train" and cell.model_flops > 0
    state = cell.args[0]
    before = {k: v.clone() for k, v in state["params"].items()
              if isinstance(v, torch.Tensor)}
    for step in range(3):
        out, metrics = cell.run()
        assert out is state
        assert torch.isfinite(metrics["loss"]) and metrics["gnorm"] > 0
        assert int(state["opt"].count) == step + 1
    moved = [k for k, v in before.items() if not torch.equal(v,
                                                            state["params"][k])]
    assert moved
    nxt = cell.batch_at(5)
    assert [a.shape for a in nxt] == [a.shape for a in cell.args[1:]]
    assert all(torch.equal(a, b) for a, b in zip(nxt, cell.batch_at(5)))


def test_train_cuts_are_recorded():
    cell = build_cell("glm4-9b", "train_4k", smoke=True, device="cpu",
                      batch=1, layers=1)
    assert cell.meta["reduced"] == {"n_layers": [2, 1], "batch": [2, 1]}
    assert cell.meta["cfg"].n_layers == 1
    assert cell.args[1].shape == (1, 64)
    _, metrics = cell.run()
    assert torch.isfinite(metrics["loss"])


def test_lm_train_layers_fit_the_budget():
    from repro_torch.launch.steps import lm_train_layers
    cfg = glm4_9b.CONFIG
    per_layer = (cfg.param_count() - dataclasses.replace(
        cfg, n_layers=0).param_count()) // cfg.n_layers
    fixed = cfg.param_count() - cfg.n_layers * per_layer
    for n in (1, 8, 13):
        budget = 16 * (fixed + n * per_layer) + 5 * 2 ** 30
        assert lm_train_layers(cfg, budget, 5 * 2 ** 30) == n
        assert lm_train_layers(cfg, budget - 1, 5 * 2 ** 30) == max(1, n - 1)
    assert lm_train_layers(cfg, 10 ** 15, 0) == 40


def test_train_cli_resumes(tmp_path, capsys):
    """The train CLI checkpoints, and a second run resumes after the last
    saved step and ends where one uninterrupted run ends."""
    from repro_torch.launch import train
    args = ["--arch", "dlrm-rm2", "--smoke", "--device", "cpu",
            "--ckpt-every", "2"]
    first = train.main(args + ["--steps", "3",
                               "--ckpt-dir", str(tmp_path / "a")])
    assert first["step"] == 2
    second = train.main(args + ["--steps", "5",
                                "--ckpt-dir", str(tmp_path / "a")])
    assert "resumed from step 2" in capsys.readouterr().out
    whole = train.main(args + ["--steps", "5",
                               "--ckpt-dir", str(tmp_path / "b")])
    assert second["step"] == whole["step"] == 4
    assert second["loss"] == whole["loss"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train.main(["--arch", "gemma3-12b", "--device", "cpu"])


def test_batch_cut_is_recorded():
    cell = build_cell("dlrm-rm2", "serve_p99", smoke=True, device="cpu",
                      batch=3)
    assert cell.meta["reduced"] == {"batch": [8, 3]}
    assert cell.run().shape == (3,)
    assert "reduced" not in build_cell("dlrm-rm2", "serve_p99", smoke=True,
                                       device="cpu").meta
