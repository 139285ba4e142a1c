"""The port's checkpointing, fault tolerance and data streams against the
JAX package's.

* ``tests/test_checkpoint_ft.py``'s cases on the port (all but
  ``surviving_mesh``, which comes with the distributed slice);
* checkpoints cross between the packages both ways: the same tree saved
  by each gives byte-equal ``.npy`` files and equal manifests, and each
  restores the other's bit for bit (bf16 leaves included);
* ``StepMonitor`` verdicts equal the JAX monitor's on the same duration
  sequences;
* ``TokenStream`` / ``RecsysStream`` batches equal the JAX streams' for
  the same (seed, step).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint import load_pytree as jload
from repro.checkpoint import save_pytree as jsave
from repro.data import RecsysStream as JRecsys
from repro.data import TokenStream as JTokens
from repro.ft import StepMonitor as JMonitor
from repro.ft import StragglerPolicy as JPolicy
from repro.optim import adamw_init as jadamw_init
from repro_torch.checkpoint import CheckpointManager, load_pytree, save_pytree
from repro_torch.data import RecsysStream, TokenStream
from repro_torch.ft import ElasticTrainer, StepMonitor, StragglerPolicy
from repro_torch.optim import OptState, adamw_init
from repro_torch.tree import flatten_with_paths, leaves


def _state():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "layers": [{"a": torch.ones((2, 2))},
                                  {"a": torch.zeros((2, 2))}]},
            "step": torch.tensor(7, dtype=torch.int32)}


def _equal(a, b):
    for x, y in zip(leaves(a), leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    state = _state()
    mgr.save(7, state)
    restored, extra = mgr.restore(state)
    assert extra["step"] == 7
    _equal(state, restored)


def test_async_save_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2, async_write=True)
    state = _state()
    for s in (1, 2, 3, 4):
        mgr.save(s, state)
    mgr.wait()
    assert mgr.all_steps() == [3, 4]


def test_async_save_copies_before_returning(tmp_path):
    """The state may change in place after ``save`` returns (the train
    step updates it in place): the checkpoint holds the saved values."""
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    state = _state()
    want = {"params": {"w": state["params"]["w"].clone(),
                       "layers": [{"a": torch.ones((2, 2))},
                                  {"a": torch.zeros((2, 2))}]},
            "step": state["step"].clone()}
    mgr.save(1, state)
    state["params"]["w"].add_(100.0)
    restored, _ = mgr.restore(state)
    _equal(restored, want)


def test_checksum_detects_corruption(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    state = _state()
    mgr.save(1, state)
    d = os.path.join(str(tmp_path), "step_00000001")
    victim = [f for f in os.listdir(d) if f.endswith(".npy")][0]
    arr = np.load(os.path.join(d, victim))
    np.save(os.path.join(d, victim), arr + 1)
    with pytest.raises(IOError):
        mgr.restore(state)


def test_crash_mid_write_keeps_previous(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    state = _state()
    mgr.save(1, state)
    os.makedirs(os.path.join(str(tmp_path), "step_00000002.tmp"))
    assert mgr.latest_step() == 1
    _, extra = mgr.restore(state)
    assert extra["step"] == 1


def test_elastic_trainer_recovers_from_injected_failures(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False, keep_last=5)
    crashes = {15: True, 27: True}

    def injector(step):
        if crashes.pop(step, None):
            raise RuntimeError(f"injected failure at step {step}")

    def build(n_devices, restored):
        state = restored if restored is not None else {"w": torch.zeros(4)}

        def step_fn(state, step):
            return {"w": state["w"] + 1.0}
        return state, step_fn

    trainer = ElasticTrainer(ckpt=mgr, build=build, total_steps=40,
                             ckpt_every=10, failure_injector=injector)
    state, log = trainer.run(n_devices=1)
    assert log["restarts"] == 2
    assert log["resumed_from"] == [9, 19]
    np.testing.assert_allclose(state["w"].numpy(), 40.0)


def test_elastic_restart_waits_for_the_write_in_flight(tmp_path,
                                                      monkeypatch):
    """A failure right after an async save: the restart resumes from that
    save's step, though its writer is slow."""
    import time

    from repro_torch.checkpoint import manager
    slow = manager.save_pytree

    def save_slowly(*args, **kwargs):
        time.sleep(0.2)
        slow(*args, **kwargs)
    monkeypatch.setattr(manager, "save_pytree", save_slowly)
    mgr = CheckpointManager(str(tmp_path), async_write=True, keep_last=5)
    failed = []

    def injector(step):
        if step == 2 and not failed:
            failed.append(step)
            raise RuntimeError("injected")

    def build(n_devices, restored):
        state = restored if restored is not None else {"w": torch.zeros(3)}
        return state, lambda state, step: {"w": state["w"] + 1.0}
    state, log = ElasticTrainer(ckpt=mgr, build=build, total_steps=4,
                                ckpt_every=2,
                                failure_injector=injector).run(1)
    assert log["resumed_from"] == [1] and log["steps_run"] == 4
    np.testing.assert_allclose(state["w"].numpy(), 4.0)


def test_elastic_resume_restores_an_optimizer_state(tmp_path):
    """A restored ``OptState`` comes back, from the manifest alone, as a
    dict of m, v and count, equal to the saved one."""
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    params = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3)}
    opt = adamw_init(params)
    mgr.save(3, {"params": params, "opt": OptState(opt.m, opt.v,
                                                   opt.count + 5)})
    template, extra = mgr.peek()
    assert extra["step"] == 3
    assert template["opt"]["count"].dtype == "int32"
    assert template["params"]["w"].shape == (2, 3)
    restored, _ = mgr.restore(template)
    assert int(restored["opt"]["count"]) == 5
    _equal(restored["params"], params)
    _equal(restored["opt"]["m"], opt.m)


def test_step_monitor_verdicts_match_jax():
    """The JAX test's hand case, then seeded duration sequences through
    both monitors under several policies."""
    mon = StepMonitor(StragglerPolicy(straggler_factor=1.5, hang_factor=5.0,
                                      min_samples=3, patience=2))
    for _ in range(5):
        assert mon.observe(1.0) == "ok"
    assert mon.observe(1.6) == "ok"
    assert mon.observe(1.7) == "straggler"
    assert mon.observe(10.0) == "hang"
    rng = np.random.default_rng(4)
    for policy in (dict(), dict(min_samples=2, patience=1, window=5),
                   dict(straggler_factor=1.2, hang_factor=3.0, patience=2)):
        ours, theirs = StepMonitor(StragglerPolicy(**policy)), \
            JMonitor(JPolicy(**policy))
        durations = rng.lognormal(0.0, 0.5, 300)
        durations[rng.random(300) < 0.05] *= 8
        for d in durations:
            assert ours.observe(float(d)) == theirs.observe(float(d))
        assert ours.events == theirs.events
        assert ours.median == theirs.median


@pytest.mark.parametrize("seed,step", [(3, 10), (0, 0), (7, 123)])
def test_data_streams_match_jax(seed, step):
    for kw in (dict(vocab=128, batch=4, seq_len=16),
               dict(vocab=151552, batch=2, seq_len=64)):
        ours = TokenStream(seed=seed, **kw).batch_at(step)
        for a, b in zip(ours, JTokens(seed=seed, **kw).batch_at(step)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        for a, b in zip(ours, TokenStream(seed=seed, **kw).batch_at(step)):
            np.testing.assert_array_equal(a, b)
    for kw in (dict(batch=8, vocab=100), dict(batch=64)):
        ours = RecsysStream(seed=seed, **kw).batch_at(step)
        for a, b in zip(ours, JRecsys(seed=seed, **kw).batch_at(step)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_token_stream_file_mode_matches_jax(tmp_path):
    path = str(tmp_path / "corpus.bin")
    np.random.default_rng(1).integers(0, 256, 5000).astype(
        np.uint8).tofile(path)
    for a, b in zip(TokenStream(256, 3, 32, seed=2, path=path).batch_at(5),
                    JTokens(256, 3, 32, seed=2, path=path).batch_at(5)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# checkpoints across the packages
# --------------------------------------------------------------------------

def _train_like_trees():
    """One state in both packages: f32 params (a stacked layer list and a
    norm), bf16 leaves, an AdamW state with an int32 count, a bare int."""
    rng = np.random.default_rng(0)
    params = {"embed": rng.normal(size=(16, 4)).astype(np.float32),
              "layers": [{"wq": rng.normal(size=(2, 4, 4)).astype(np.float32),
                          "ln1": rng.normal(size=(2, 4)).astype(np.float32)}],
              "ln_f": rng.normal(size=(4,)).astype(np.float32)}
    half = rng.normal(size=(3, 5)).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, params)
    jopt = jadamw_init(jparams)
    jopt = jopt._replace(
        m=jax.tree.map(lambda a: a + 0.5, jopt.m), count=jnp.int32(9))
    jtree = {"params": jparams, "opt": jopt,
             "half": jnp.asarray(half, jnp.bfloat16)}
    tparams = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    topt = adamw_init(tparams)
    topt = OptState(jax.tree.map(lambda a: a + 0.5, topt.m), topt.v,
                    torch.tensor(9, dtype=torch.int32))
    ttree = {"params": tparams, "opt": topt,
             "half": torch.from_numpy(half).to(torch.bfloat16)}
    return jtree, ttree


def test_checkpoints_are_byte_equal_across_packages(tmp_path):
    jtree, ttree = _train_like_trees()
    jsave(jtree, str(tmp_path / "jax"), {"step": 9})
    save_pytree(ttree, str(tmp_path / "torch"), {"step": 9})
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "torch"))
    assert "opt__count.npy" in names and "params__layers__0__wq.npy" in names
    for name in names:
        a = (tmp_path / "jax" / name).read_bytes()
        b = (tmp_path / "torch" / name).read_bytes()
        if name == "manifest.json":
            assert json.loads(a) == json.loads(b)
        else:
            assert a == b, name
    keys = [rec["key"] for rec in
            json.loads((tmp_path / "torch" / "manifest.json").read_text())[
                "leaves"]]
    assert keys == [k for k, _ in flatten_with_paths(ttree)]
    assert "opt/count" in keys and "half" in keys


def test_port_restores_a_jax_checkpoint(tmp_path):
    jtree, ttree = _train_like_trees()
    mgr = JManager(str(tmp_path), async_write=False)
    mgr.save(9, jtree)
    restored, extra = CheckpointManager(str(tmp_path)).restore(ttree)
    assert extra["step"] == 9
    assert isinstance(restored["opt"], OptState)
    assert restored["half"].dtype == torch.bfloat16
    _equal(restored, ttree)


def test_jax_restores_a_port_checkpoint(tmp_path):
    """The JAX loader reads the port's files; its f32 and int leaves come
    back equal (a bf16 leaf reads back as the 2-byte void numpy saves, in
    both packages' files, so the bits are compared)."""
    jtree, ttree = _train_like_trees()
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    mgr.save(9, ttree)
    mgr.wait()
    like = {"params": jtree["params"], "opt": jtree["opt"]}
    restored, extra = jload(str(tmp_path / "step_00000009"), like)
    assert extra["step"] == 9
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(like)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    half = np.load(str(tmp_path / "step_00000009" / "half.npy"))
    np.testing.assert_array_equal(
        half.view(np.uint16),
        np.asarray(jtree["half"]).view(np.uint16))
