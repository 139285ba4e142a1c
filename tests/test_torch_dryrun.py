"""The port's dry run (``repro_torch.launch.dryrun``): its abstract cells
against the concrete ones and the JAX package's model FLOPs, its
collective and argument counts against real gloo runs, its full-size
cells against closed forms, and the kernels' fake forms and cost
functions.

``run_cell`` starts a process group, which is process-wide (and the
test workers are processes), so it runs in subprocesses here, started
with the gloo ranks before the in-process checks.  Torch runs at one
thread in this process.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

import torchdist
from repro.launch.steps import model_flops_for
from repro_torch import kernels
from repro_torch.configs import all_cells, get_arch
from repro_torch.device import fake_device
from repro_torch.launch import steps
from repro_torch.launch.steps import build_cell
from repro_torch.tree import leaves
from torchdist_dryrun_bodies import _sigs

ROOT = Path(__file__).resolve().parent.parent

#: A smoke cell of each family: LM train and decode, a GNN, rm2 train.
SMOKE = [("glm4-9b", "train_4k"), ("glm4-9b", "decode_32k"),
         ("gcn-cora", "full_graph_sm"), ("dlrm-rm2", "train_batch")]
STEPPED = [("glm4-9b", "train_4k"), ("dlrm-rm2", "train_batch")]
MESHES = [(1, 2), (2, 2)]

# run_cell in a child: argv[1] is a JSON list of run_cell keyword sets;
# it prints the reports as one JSON list
_RUN = """
import json, sys
from repro_torch.launch.dryrun import run_cell
out = []
for kw in json.loads(sys.argv[1]):
    r = run_cell(**kw)
    out.append(r)
json.dump(out, sys.stdout)
"""


class _Child:
    """``run_cell`` over a list of keyword sets, in a child process."""

    def __init__(self, calls):
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _RUN, json.dumps(calls)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=str(ROOT), env={**os.environ, "PYTHONPATH": str(ROOT / "src")})

    def results(self):
        out, err = self.proc.communicate(timeout=240)
        assert self.proc.returncode == 0, err[-4000:]
        return json.loads(out)


@pytest.fixture(scope="module")
def background():
    """The gloo ranks of (a) and (c) and the run_cell children of (c)
    and (d), started together; the tests collect them."""
    ranks = torchdist.Ranks(4, "torchdist_dryrun_bodies:dryrun_battery",
                            {"cells": SMOKE, "stepped": STEPPED},
                            timeout=180)
    fake = _Child([dict(arch=a, shape=s, mesh_shape=m, smoke=True)
                   for m in MESHES for a, s in STEPPED])
    full = _Child([dict(arch="glm4-9b", shape="train_4k", mesh_kind="single",
                        layers=2),
                   dict(arch="glm4-9b", shape="decode_32k",
                        mesh_kind="single"),
                   dict(arch="dlrm-rm2", shape="train_batch",
                        mesh_kind="single")])
    try:
        yield {"ranks": ranks, "fake": fake, "full": full}
    finally:
        ranks.close()
        for child in (fake, full):
            if child.proc.poll() is None:
                child.proc.kill()
                child.proc.communicate()


@pytest.fixture(autouse=True)
def _one_thread():
    with torchdist.one_thread():
        yield


# --------------------------------------------------------------------------
# (a) the abstract cell is the concrete cell, leaf by leaf


@pytest.mark.parametrize("arch,shape", SMOKE)
def test_abstract_cell_matches_concrete(background, arch, shape):
    concrete = build_cell(arch, shape, smoke=True, device="cpu")
    abstract = build_cell(arch, shape, smoke=True, abstract=True)
    assert _sigs(abstract.args) == _sigs(concrete.args)
    ts = [t for t in leaves(abstract.args) if isinstance(t, torch.Tensor)]
    assert all(isinstance(t, FakeTensor) and t.device == fake_device()
               for t in ts)
    assert abstract.model_flops == concrete.model_flops


# --------------------------------------------------------------------------
# (b) model FLOPs of every cell, and nothing drawn on the host


def _refuse(what):
    def refuse(*args, **kwargs):
        raise AssertionError(f"the abstract path called {what}")
    return refuse


def test_model_flops_match_jax_for_every_cell(monkeypatch):
    """Every full-size cell of ``all_cells()``, built abstract, has JAX's
    ``model_flops_for`` (mesh-free: no padding), exactly; no data stream,
    graph, sampler or card generator is touched."""
    for name in ("TokenStream", "RecsysStream", "_gnn_concrete_batch",
                 "_minibatch_sampler", "resolve_device", "make_graph_batch",
                 "synth_molecule_batch"):
        monkeypatch.setattr(steps, name, _refuse(name))
    real_generator = torch.Generator

    def generator(device="cpu"):
        assert torch.device(device).type == "cpu", device
        return real_generator(device)
    monkeypatch.setattr(torch, "Generator", generator)
    cells, skipped = all_cells()
    assert len(cells) == 36 and len(skipped) == 4
    for arch, shape in cells:
        cell = build_cell(arch, shape, abstract=True)
        assert cell.model_flops == model_flops_for(arch, shape, mult=1), \
            (arch, shape)


# --------------------------------------------------------------------------
# (a), (c): under gloo meshes


def test_abstract_blocks_match_concrete_on_gloo_meshes(background):
    got = background["ranks"].results()
    for rank, per_mesh in enumerate(got):
        for mesh in MESHES:
            if mesh == (1, 2) and rank > 1:
                assert mesh not in per_mesh
                continue
            for cell in SMOKE:
                r = per_mesh[mesh][cell]
                assert r["abstract"] == r["concrete"], (rank, mesh, cell)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("cell", STEPPED)
def test_fake_counts_match_gloo(background, mesh, cell):
    """The fake group's collective bytes by kind equal rank 0's real
    gloo step counted by the same ``OpAnalysis``; ``argument_bytes``
    equals rank 0's blocks by ``block_slices``."""
    reports = background["fake"].results()
    rep = reports[[(m, c) for m in MESHES for c in STEPPED].index(
        (mesh, cell))]
    assert rep["ok"] and rep["mesh_shape"] == list(mesh)
    real = background["ranks"].results()[0][mesh][cell]
    assert rep["per_device"]["collectives"] == real["collectives"]
    assert sum(real["collectives"].values()) > 0
    assert rep["per_device"]["argument_bytes"] == real["block_bytes"]


# --------------------------------------------------------------------------
# (d) full-size cells on the single mesh against closed forms


def _glm4_train_matmul(layers: int, tp: int = 16, dp: int = 16) -> float:
    """Rank 0's product FLOPs of a glm4-9b train_4k step on (dp, tp):
    each cycle's forward runs twice (remat) and its backward twice over,
    the head's chunked loss likewise; the non-reentrant checkpoint stops
    its recompute once the saved tensors are back, so each cycle's last
    product, the down projection, runs once."""
    c = get_arch("glm4-9b").CONFIG
    d, hd, f_l, v_l = c.d_model, c.hd, c.d_ff // tp, c.vocab // tp
    b, s = 256 // dp, 4096
    t, h_l = b * s, c.n_heads // tp
    kv_l = max(1, c.n_kv_heads // tp)       # the KV head its heads read
    layer = (2 * t * d * h_l * hd + 2 * 2 * t * d * kv_l * hd
             + 4 * b * h_l * s * s * hd      # every chunk pair, masked
             + 2 * t * h_l * hd * d + 3 * 2 * t * d * f_l)
    head = 2 * t * d * v_l
    return 4 * (layers * layer + head) - layers * 2 * t * f_l * d


def _glm4_decode_matmul(tp: int = 16, dp: int = 16) -> float:
    """Rank 0's product FLOPs of a glm4-9b decode_32k step: its batch
    rows, its heads' columns, and split-KV attention over its block of
    the cache for every head."""
    c = get_arch("glm4-9b").CONFIG
    d, hd = c.d_model, c.hd
    b, s = 128 // dp, 32768
    layer = (2 * b * d * (c.n_heads * hd // tp)
             + 2 * 2 * b * d * (c.n_kv_heads * hd // tp)
             + 2 * 2 * b * c.n_heads * (s // tp) * hd
             + 2 * b * (c.n_heads * hd // tp) * d
             + 3 * 2 * b * d * (c.d_ff // tp))
    return c.n_layers * layer + 2 * b * d * (c.vocab // tp)


def _rm2_train_matmul(dp: int = 16) -> float:
    """Rank 0's product FLOPs of a dlrm-rm2 train_batch step: forward
    and backward (both operands' gradients) of every product, but the
    first bottom layer's input (the dense features) takes none."""
    c = get_arch("dlrm-rm2").CONFIG
    b = 65536 // dp
    bot = list(c.bot_mlp)
    top = [c.n_interactions + bot[-1]] + list(c.top_mlp)
    f = c.n_sparse + 1
    fwd = 2 * b * (sum(x * y for x, y in zip(bot, bot[1:]))
                   + f * f * c.embed_dim
                   + sum(x * y for x, y in zip(top, top[1:])))
    return 3 * fwd - 2 * b * bot[0] * bot[1]


def test_full_cells_on_the_single_mesh(background):
    train, decode, rm2 = background["full"].results()
    for rep, want in ((train, _glm4_train_matmul(2)),
                      (decode, _glm4_decode_matmul()),
                      (rm2, _rm2_train_matmul())):
        assert rep["ok"] and rep["chips"] == 256 and rep["rank"] == 0
        got = rep["per_device"]["matmul_flops"]
        assert abs(got - want) / want < 1e-3, (rep["arch"], rep["shape"],
                                               got, want)
        for key in ("hlo_flops", "hlo_bytes", "collectives",
                    "bytes_by_class", "argument_bytes", "output_bytes",
                    "temp_bytes"):
            assert key in rep["per_device"]
        assert rep["fits"] is True
        assert rep["roofline"]["dominant"] in ("compute", "memory",
                                               "collective")
    assert train["reduced"] == {"n_layers": [40, 2]}
    # decode over a mesh takes the split-KV body, not flash_decode
    assert decode["kernels"] == {}
    assert {k: v["launches"] for k, v in rm2["kernels"].items()} == {
        "embedding_bag": 1, "bag_sum_backward": 1}


# --------------------------------------------------------------------------
# (e) the fake forms, and the cost functions


@pytest.fixture
def no_build(monkeypatch):
    """A fake form that reached a build or the card's occupancy query
    would fail here."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    from repro_torch.kernels.flash_decode import ops as fd_ops
    monkeypatch.setattr(_build, "load", _refuse("load"))
    monkeypatch.setattr(fd_ops, "load", _refuse("load"))
    monkeypatch.setattr(eb_ops, "load", _refuse("load"))
    monkeypatch.setattr(fd_ops, "device_config", _refuse("device_config"))
    monkeypatch.setattr(eb_ops, "bag_sum_backward_ref",
                        _refuse("bag_sum_backward_ref"))
    monkeypatch.setattr(eb_ops, "bag_sum_ref", _refuse("bag_sum_ref"))


def _fake_call(fn, *args):
    """``fn`` on fake copies of ``args`` on the fake device: (its output,
    the launches the fake forms reported)."""
    heard = []
    kernels.FAKE_LISTENERS.append(lambda *a: heard.append(a))
    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            out = fn(*[torch.empty(a.shape, dtype=a.dtype,
                                   device=fake_device())
                       if isinstance(a, torch.Tensor) else a for a in args])
    finally:
        kernels.FAKE_LISTENERS.pop()
    return out, heard


def test_fake_forms_give_the_plain_shapes(no_build):
    from repro_torch.kernels.embedding_bag import (bag_sum_backward,
                                                   bag_sum_backward_ref,
                                                   bag_sum_ref, take_fill)
    from repro_torch.kernels.embedding_bag.ops import (bag_sum,
                                                       bag_sum_backward_cost,
                                                       bag_sum_cost)
    from repro_torch.kernels.flash_decode import flash_decode_ref
    from repro_torch.kernels.flash_decode.ops import (flash_decode,
                                                      flash_decode_cost)
    g = torch.Generator().manual_seed(0)
    for dt in (torch.float32, torch.bfloat16):
        q = torch.randn(3, 8, 16, generator=g).to(dt)
        k = torch.randn(3, 40, 2, 16, generator=g).to(dt)
        v = torch.randn(3, 40, 2, 16, generator=g).to(dt)
        want = flash_decode_ref(q, k, v, 33)
        out, heard = _fake_call(flash_decode, q, k, v, 33)
        assert (out.shape, out.dtype) == (want.shape, want.dtype)
        assert heard == [("flash_decode",
                          *flash_decode_cost(3, 8, 2, 16, 33, k.element_size(),
                                             q.element_size()), dt)]
    table = torch.randn(50, 8, generator=g)
    ids = torch.randint(0, 50, (6, 3), generator=g, dtype=torch.int32)
    mask = torch.rand(6, 3, generator=g) < 0.7
    want = bag_sum_ref(take_fill(table, ids), mask)
    out, heard = _fake_call(bag_sum, table, ids, mask)
    assert (out.shape, out.dtype) == (want.shape, want.dtype)
    assert heard == [("embedding_bag", *bag_sum_cost(6, 3, 8, 18),
                      torch.float32)]
    grad = torch.randn(6, 8, generator=g)
    want = bag_sum_backward_ref(grad, ids, mask, 50)
    out, heard = _fake_call(bag_sum_backward, grad, ids, mask, 50)
    assert (out.shape, out.dtype) == (want.shape, want.dtype)
    assert heard == [("bag_sum_backward", *bag_sum_backward_cost(6, 3, 8, 18),
                      torch.float32)]
    # through autograd: the forward and its backward, one call each
    def step(t, i, m):
        t.requires_grad_(True)
        bag_sum(t, i, m).sum().backward()
        return t.grad
    out, heard = _fake_call(step, table, ids, mask)
    assert (out.shape, out.dtype) == (table.shape, table.dtype)
    assert [h[0] for h in heard] == ["embedding_bag", "bag_sum_backward"]


#: chip_smoke.py's peaks: HBM, bf16 tensor cores, and the SIMT lanes of
#: an H100 SXM (132 SMs x 128 lanes x 1,980 MHz).
HBM, BF16, SIMT = 3.35e12, 989e12, 132 * 128 * 1980e6


def _bound_ms(cost, rate):
    nbytes, ops = cost
    return max(nbytes / HBM, ops / rate) * 1e3


def test_costs_hold_the_closed_forms():
    """Each kernel's cost function at the shapes of PERF.md's table of
    kernels, against its closed form; where the shape alone decides the
    bound (no distinct-row count), the table's bound in ms."""
    from repro_torch.kernels.edge_relax.ops import relax_sweep_cost
    from repro_torch.kernels.embedding_bag.ops import (bag_sum_backward_cost,
                                                       bag_sum_cost)
    from repro_torch.kernels.flash_decode.ops import flash_decode_cost
    from repro_torch.kernels.tropical_matmul.ops import minplus_cost
    m, k = 32, 15722
    assert minplus_cost(m, k, k) == (4 * (m * k + k * k + m * k),
                                     2 * m * k * k)
    assert round(_bound_ms(minplus_cost(m, k, k), SIMT), 4) == 0.4729
    b, h, kh, dh, kv = 32, 32, 2, 128, 32761
    assert flash_decode_cost(b, h, kh, dh, kv) == (
        2 * b * kh * kv * dh * 2 + b * h * dh * 6, 4 * b * h * kv * dh)
    assert round(_bound_ms(flash_decode_cost(b, h, kh, dh, kv), BF16),
                 4) == 0.3207
    bags, rows = 262144 * 26, 5_990_000
    assert bag_sum_cost(bags, 1, 64, rows) == (
        4 * 64 * (rows + bags) + 8 * bags, 2 * bags * 64)
    n, touched = 1703936, 259_000
    assert bag_sum_backward_cost(n, 1, 64, touched) == (
        4 * n * 64 + 8 * n + 4 * 64 * touched, 2 * n * 64)
    lv, r, e, rd, wr, s = 16, 22400, 150_000, 30_000, 20_000, 32
    assert relax_sweep_cost(lv, r, e, rd, wr, s) == (
        4 * (2 * lv + 1) + 8 * r + 4 + 8 * e + 4 * s * (rd + wr),
        2 * s * e)
