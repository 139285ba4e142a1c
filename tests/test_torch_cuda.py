"""The port's CUDA kernels against their plain versions, on the card.

Skips without a CUDA device: a CUDA kernel has no CPU mode.  Run on a
GPU machine with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``; this file imports neither JAX nor the JAX
package, so it runs where only the port is installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.edge_relax import (pack_sweep, relax_sweep_,
                                            relax_sweep_ref_)
from repro_torch.kernels.embedding_bag import (backward_plan, bag_sum,
                                               bag_sum_backward,
                                               bag_sum_backward_ref,
                                               bag_sum_ref, take_fill)
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.tropical_matmul import minplus, minplus_ref
from repro_torch.kernels.tropical_matmul import ops as mp_ops
from torchsupport import plan_like_level, plan_like_sweep, t

MINPLUS_SHAPES = [(1, 1, 1), (4, 7, 9), (8, 128, 128), (64, 130, 257),
                  (128, 128, 384), (33, 65, 5), (32, 1000, 777)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", MINPLUS_SHAPES)
def test_minplus_kernel_on_card(cuda_device, m, k, n):
    rng = np.random.default_rng(m + k + n)
    a = rng.uniform(0, 10, (m, k)).astype(np.float32)
    b = rng.uniform(0, 10, (k, n)).astype(np.float32)
    a[0, 0] = np.inf
    b[rng.random((k, n)) < 0.1] = np.inf
    before = minplus.launches
    got = minplus(t(a).to(cuda_device), t(b).to(cuda_device)).cpu()
    assert minplus.launches == before + 1
    np.testing.assert_array_equal(got.numpy(), minplus_ref(t(a), t(b)).numpy())


@pytest.mark.cuda
def test_minplus_kernel_strided_rows_on_card(cuda_device):
    rng = np.random.default_rng(2)
    wide = t(rng.uniform(0, 10, (40, 300)).astype(np.float32))
    b = t(rng.uniform(0, 10, (250, 129)).astype(np.float32))
    got = minplus(wide.to(cuda_device)[:, 30:280], b.to(cuda_device))
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  minplus_ref(wide[:, 30:280], b).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,pad,n_k", [
    (32, 3, 300, 0, 8),          # K smaller than the split count
    (32, 40, 300, 0, 5),         # 2 K tiles asked for 5 chunks
    (32, 1001, 777, 0, None),    # K and N not multiples of their tiles
    (32, 1001, 777, 0, 7),       # a short last chunk
    (1, 640, 1000, 0, None), (1, 640, 1000, 0, 3),      # M = 1
    (33, 700, 260, 0, None), (33, 700, 260, 0, 4),      # M = 33
    (32, 999, 513, 13, None), (32, 999, 513, 1, 6),     # strided a
    (32, 1024, 256, 0, None),    # every width 16 bytes
    (5, 2000, 130, 2, 3)])
def test_minplus_kernel_edge_cases_on_card(cuda_device, m, k, n, pad, n_k):
    """The split-K kernel bit-equal to the plain version at the edges of
    its tiles and splits, with an all-+inf row of a, all-+inf columns of
    b, and a row of a that is +inf but for its last entry (in the last,
    ragged K tile); ``n_k`` forces a split."""
    rng = np.random.default_rng(m * 7 + k + n)
    wide = rng.uniform(0, 100, (m, k + pad)).astype(np.float32)
    b = rng.uniform(0, 1000, (k, n)).astype(np.float32)
    wide[rng.random(wide.shape) < 0.3] = np.inf
    b[rng.random(b.shape) < 0.05] = np.inf
    wide[0, :k] = np.inf
    wide[0, k - 1] = 1.0
    inf_rows = [m - 1] if m > 1 else []
    wide[inf_rows] = np.inf
    b[:, n // 3] = np.inf
    b[:, -1] = np.inf
    a = t(wide).to(cuda_device)[:, :k]
    bd = t(b).to(cuda_device)
    before = minplus.launches
    got = minplus(a, bd) if n_k is None else mp_ops._launch(a, bd, n_k=n_k)
    assert minplus.launches == before + 1
    want = minplus_ref(t(wide)[:, :k], t(b))
    assert torch.equal(got.cpu(), want)
    assert torch.isinf(got[inf_rows]).all() and torch.isinf(got[:, -1]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kh,dh,s,kv_len,n_split", [
    (2, 32, 2, 128, 2048, 1, None),          # kv_len 1
    (2, 32, 2, 128, 2048, 1, 4),
    (2, 32, 2, 128, 2048, 64 * 7 + 17, None),  # ends mid-tile, mid-ring
    (2, 32, 2, 128, 2048, 64 * 3 + 1, 1),      # one split: mid-ring
    (2, 32, 2, 128, 1000, 999, None),        # kv_len < S, S no tile multiple
    (2, 32, 2, 128, 2048, 640, 3),           # last split short (4+4+2 tiles)
    (1, 16, 1, 128, 4096, 4096, 5),          # 13 + 13 + 13 + 13 + 12 tiles
    (3, 48, 3, 64, 1500, 1300, 7),
    (1, 4, 4, 64, 640, 300, 2), (2, 16, 2, 64, 700, 650, None),
    (2, 32, 2, 32, 2048, 640, 3),            # dh 32: 64-column boxes
    (3, 15, 3, 32, 1000, 999, 4),            # dh 32, one head: 32 columns
    (2, 8, 2, 16, 1000, 700, 3),             # dh 16, two heads: 32 columns
    (1, 8, 1, 16, 2048, 2000, 5)])           # dh 16, one head: 16 columns
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_ring_edge_cases_on_card(cuda_device, b, h, kh, dh, s,
                                              kv_len, n_split, q_dtype):
    """The tensor-core form's TMA ring at its edges (tiles cut by the end
    of the tensor map, short last splits, one and two KV heads a block),
    with f32 q (three q terms) and bf16 q (one), atol 1e-4 against the
    plain version; ``n_split`` forces the split count."""
    rng = np.random.default_rng(b * h + s + kv_len)
    q = t(rng.normal(size=(b, h, dh)).astype(np.float32)).to(q_dtype)
    kc = t(rng.normal(size=(b, s, kh, dh)).astype(np.float32)).bfloat16()
    vc = t(rng.normal(size=(b, s, kh, dh)).astype(np.float32)).bfloat16()
    args = [x.to(cuda_device) for x in (q, kc, vc)]
    before = flash_decode.launches
    got = (flash_decode(*args, kv_len) if n_split is None
           else fd_ops._launch(*args, kv_len, n_split=n_split))
    assert flash_decode.launches == before + 1
    want = flash_decode_ref(q, kc, vc, kv_len)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4,
                               rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("s,n,m,k", [(1, 10, 4, 1), (33, 500, 96, 16),
                                     (70, 2000, 300, 40),
                                     (32, 4000, 2240, 16)])
def test_relax_level_kernel_on_card(cuda_device, s, n, m, k):
    """One level as a one-level sweep, on the node-major state."""
    dist, dst, src, w, valid = plan_like_level(s, n, m, k, seed=m)
    sweep = pack_sweep([(dst, src, w, valid)], n + 1)
    before = relax_sweep_.launches
    got = relax_sweep_(t(dist.T).to(cuda_device),
                       pack_sweep([(dst, src, w, valid)], n + 1,
                                  cuda_device)).cpu()
    assert relax_sweep_.launches == before + 1
    want = relax_sweep_ref_(t(dist.T), sweep)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 7, 32, 33, 64, 128])
@pytest.mark.parametrize("n,n_levels,m,k,empty", [
    (20000, 6, 3000, 16, ()),          # many blocks a level, split rows
    (3000, 5, 400, 40, (2,)),          # long rows; an empty level inside
    (900, 3, 8, 2, (0, 2))])           # empty first and last levels
def test_relax_sweep_kernel_on_card(cuda_device, s, n, n_levels, m, k,
                                    empty):
    """A multi-level sweep in one launch equals the plain version: each
    level reads what the one before it wrote, across blocks, so a
    missing or leaky grid barrier shows.  S covers the 16-byte form
    (32, 64, 128) and the 4-byte form (1, 7, 33)."""
    dist, levels = plan_like_sweep(s, n, n_levels, m, k, seed=n + s,
                                   empty=empty)
    want = relax_sweep_ref_(t(dist.copy()), pack_sweep(levels, n + 1))
    before = relax_sweep_.launches
    got = relax_sweep_(t(dist).to(cuda_device),
                       pack_sweep(levels, n + 1, cuda_device)).cpu()
    assert relax_sweep_.launches == before + 1
    assert torch.equal(got, want)
    assert torch.isinf(got[n]).all()
    assert not torch.equal(got, t(dist))


@pytest.mark.cuda
def test_relax_sweep_of_many_levels(cuda_device):
    """A chain of 1,030 one-row levels, each reading what the one before
    wrote, in one launch: 1,029 grid barriers, and the plain version's
    answer."""
    n = 1031
    levels = [(np.array([i + 1], np.int32), np.array([[i]], np.int32),
               np.array([[1.0]], np.float32), np.array([True]))
              for i in range(n - 1)]
    dist = np.full((n + 1, 5), np.inf, np.float32)
    dist[0] = 0.0
    want = relax_sweep_ref_(t(dist.copy()), pack_sweep(levels, n + 1))
    assert want[n - 1].tolist() == [n - 1.0] * 5
    before = relax_sweep_.launches
    got = relax_sweep_(t(dist).to(cuda_device),
                       pack_sweep(levels, n + 1, cuda_device)).cpu()
    assert relax_sweep_.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_relax_sweep_without_slots_launches_nothing(cuda_device):
    dist = torch.rand(50, 32, device=cuda_device)
    before = relax_sweep_.launches
    for sweep in (pack_sweep([], 50, cuda_device),
                  pack_sweep(plan_like_sweep(32, 49, 2, 8, 3, seed=0,
                                             empty=(0, 1))[1], 50,
                             cuda_device)):
        assert torch.equal(relax_sweep_(dist.clone(), sweep), dist)
    assert relax_sweep_.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("forward", [True, False])
def test_relax_served_sweeps_on_card(cuda_device, forward):
    """The full served index's sweep (grid side 200, the serve CLI's
    build) in one launch, bit-equal to the plain version on the card,
    from random labels and from a batch's initial state."""
    from repro_torch.core import BuildConfig, build_hod_fast, grid_road_graph
    from repro_torch.core import pack_index
    from repro_torch.core.query import _plan_sweep
    g = grid_road_graph(200, seed=0)
    res = build_hod_fast(g, BuildConfig(max_core_nodes=512,
                                        max_core_edges=1 << 15))
    ix = pack_index(g, res, chunk=2048, k_cap=16, closure_limit=0,
                    device="cpu")
    sweep = _plan_sweep(ix.plan_f if forward else ix.plan_b, ix.n_pad,
                        cuda_device)
    assert sweep.n_levels == 8
    gen = torch.Generator(device=cuda_device).manual_seed(int(forward))
    rand = torch.randint(0, 200, (ix.n_pad, 32), generator=gen,
                         device=cuda_device).float()
    rand[torch.rand(rand.shape, generator=gen, device=cuda_device)
         < 0.25] = float("inf")
    init = torch.full((ix.n_pad, 32), float("inf"), device=cuda_device)
    init[torch.randint(0, ix.n, (32,), generator=gen, device=cuda_device),
         torch.arange(32, device=cuda_device)] = 0.0
    for dist in (rand, init):
        dist[ix.n] = float("inf")
        got = relax_sweep_(dist.clone(), sweep)
        want = relax_sweep_ref_(dist.clone(), sweep)
        assert torch.equal(got, want)
        assert not torch.equal(got, dist)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kh,dh,s,kv_len", [
    (1, 4, 4, 16, 64, 1), (2, 8, 2, 16, 96, 17), (2, 8, 8, 32, 128, 128),
    (1, 16, 4, 64, 256, 200), (3, 32, 2, 128, 1000, 999),
    (2, 32, 2, 128, 4096, 4096), (1, 12, 3, 256, 77, 300),
    (2, 32, 1, 64, 300, 250), (5, 6, 6, 128, 131, 65),
    (2, 24, 2, 96, 200, 150), (1, 32, 1, 48, 150, 149),
    (2, 6, 3, 16, 300, 257), (1, 10, 5, 32, 500, 450)])
@pytest.mark.parametrize("dtype,q_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
def test_flash_decode_kernel_on_card(cuda_device, b, h, kh, dh, s, kv_len,
                                     dtype, q_dtype):
    """The split-KV kernel against its plain version; atol 1e-4 on the f32
    output (both keep scores and p in f32; only the order of the softmax
    sums differs).  bf16 caches with G <= 16 and dh in {16, 32, 64, 128}
    take the tensor-core form (an f32 q as three bf16 terms), the rest
    SIMT.  The last two shapes give the SIMT form more than one
    accumulator a thread with dh/4 not dividing its 256 threads."""
    rng = np.random.default_rng(b * h + s)
    q = t(rng.normal(size=(b, h, dh)).astype(np.float32)).to(q_dtype)
    kc = t(rng.normal(size=(b, s, kh, dh)).astype(np.float32)).to(dtype)
    vc = t(rng.normal(size=(b, s, kh, dh)).astype(np.float32)).to(dtype)
    before = flash_decode.launches
    got = flash_decode(q.to(cuda_device), kc.to(cuda_device),
                       vc.to(cuda_device), kv_len).cpu()
    assert flash_decode.launches == before + 1
    want = flash_decode_ref(q, kc, vc, kv_len)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("v,d,b,k", [
    (10, 8, 3, 2), (50, 24, 9, 6), (100, 128, 32, 4), (7, 64, 17, 1),
    (1000, 64, 4096, 1), (33, 5, 40, 3), (300, 4096, 5, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bag_sum_kernel_on_card(cuda_device, v, d, b, k, dtype):
    """Bit-equal to the plain version: both round each product to the
    table's dtype and sum over k in order in f32.  The ids include
    ``jnp.take``'s out-of-range cases: -1 and -V wrap, V and -V-1 give
    zero rows."""
    rng = np.random.default_rng(v + d + b)
    tab = t(rng.normal(size=(v, d)).astype(np.float32)).to(dtype)
    ids = rng.integers(0, v, (b, k)).astype(np.int32)
    ids.flat[:4] = [-1, v, -v, -v - 1][:ids.size]
    mask = t(rng.random((b, k)) < 0.7)
    before = bag_sum.launches
    got = bag_sum(tab.to(cuda_device), t(ids).to(cuda_device),
                  mask.to(cuda_device)).cpu()
    assert bag_sum.launches == before + 1
    assert got.dtype == dtype
    want = bag_sum_ref(take_fill(tab, t(ids)), mask)
    np.testing.assert_array_equal(got.float().numpy(), want.float().numpy())


def _zipf_bags(v, b, k, d, seed, hot=0):
    """Zipf(1.2) ids (row 0 about 18% of the slots, as RecsysStream's),
    ``hot`` extra slots on row 1, every out-of-range case, a weighted
    mask with zeros, and a gradient."""
    rng = np.random.default_rng(seed)
    ids = np.minimum(rng.zipf(1.2, (b, k)) - 1, v - 1).astype(np.int32)
    ids.reshape(-1)[rng.permutation(b * k)[:hot]] = 1
    ids.flat[:4] = [-1, v, -v, -v - 1]
    mask = (rng.random((b, k)) < 0.8) * rng.normal(size=(b, k))
    g = rng.normal(size=(b, d))
    return (t(ids), t(mask.astype(np.float32)), t(g.astype(np.float32)))


def _counts(ids, v):
    rows, _ = backward_plan(ids, v)
    return torch.bincount(rows.long(), minlength=v + 1)[:v].float()


@pytest.mark.cuda
@pytest.mark.parametrize("v,b,k,d,hot", [
    (1000, 4096, 1, 64, 0), (1000, 4096, 1, 64, 3000), (50, 300, 3, 5, 40),
    (7, 200, 2, 8, 0), (10 ** 6, 65536, 1, 64, 0), (300, 77, 4, 128, 100),
    (3, 33, 1, 4, 0)])
def test_bag_sum_backward_kernel_on_card(cuda_device, v, b, k, d, hot):
    """Against the plain version on Zipf ids with a hot row: rtol 1e-5 and
    atol 1e-6 x the row's slot count (f32 sums associated at chunk
    boundaries); rows of one slot, summed the same way, bit-equal; the
    same bits at every launch; untouched rows stay zero."""
    ids, mask, g = _zipf_bags(v, b, k, d, seed=v + b + k, hot=hot)
    want = bag_sum_backward_ref(g, ids, mask, v)
    cnt = _counts(ids, v)
    before = bag_sum_backward.launches
    got = bag_sum_backward(g.to(cuda_device), ids.to(cuda_device),
                           mask.to(cuda_device), v)
    again = bag_sum_backward(g.to(cuda_device), ids.to(cuda_device),
                             mask.to(cuda_device), v)
    assert bag_sum_backward.launches == before + 2
    assert torch.equal(got, again)
    got = got.cpu()
    err = (got - want).abs()
    assert (err <= 1e-5 * want.abs() + 1e-6 * cnt[:, None]).all(), \
        err.max().item()
    assert torch.equal(got[cnt <= 1], want[cnt <= 1])
    assert not got[cnt == 0].any()


@pytest.mark.cuda
def test_bag_sum_backward_through_autograd_on_card(cuda_device):
    """``bag_sum``'s Function on the card: the table's gradient comes from
    the kernel (one launch a backward), equal to the CPU's within the
    kernel test's bound, and reruns into a given ``out`` are idempotent."""
    ids, mask, g = _zipf_bags(500, 2048, 2, 16, seed=3)
    tab = torch.zeros(500, 16, device=cuda_device, requires_grad=True)
    before = bag_sum_backward.launches
    out = bag_sum(tab, ids.to(cuda_device), mask.to(cuda_device))
    (got,) = torch.autograd.grad(out, [tab], g.to(cuda_device))
    assert bag_sum_backward.launches == before + 1
    want = bag_sum_backward_ref(g, ids, mask, 500)
    cnt = _counts(ids, 500)
    assert ((got.cpu() - want).abs()
            <= 1e-5 * want.abs() + 1e-6 * cnt[:, None]).all()
    buf = torch.zeros_like(got)
    for _ in range(2):
        bag_sum_backward(g.to(cuda_device), ids.to(cuda_device),
                         mask.to(cuda_device), 500, out=buf)
        assert torch.equal(buf, got)
    with pytest.raises(ValueError, match="float32"):
        bag_sum_backward(g.to(cuda_device).double(), ids.to(cuda_device),
                         mask.to(cuda_device), 500)
    with pytest.raises(ValueError, match="out must be"):
        bag_sum_backward(g.to(cuda_device), ids.to(cuda_device),
                         mask.to(cuda_device), 500, out=buf[:10])


@pytest.mark.cuda
def test_wrappers_reject_bad_cuda_inputs(cuda_device):
    a = torch.ones(4, 5, device=cuda_device)
    with pytest.raises(ValueError):
        minplus(a, torch.ones(5, 3))                      # mixed devices
    with pytest.raises(ValueError):
        minplus(a.double(), torch.ones(5, 3, dtype=torch.float64,
                                       device=cuda_device))
    with pytest.raises(ValueError):
        minplus(a, torch.ones(3, 5, device=cuda_device).t())  # b strided
    dist, dst, src, w, valid = plan_like_level(2, 10, 4, 1, seed=0)
    on_card = pack_sweep([(dst, src, w, valid)], 11, cuda_device)
    labels = t(dist.T).to(cuda_device)
    with pytest.raises(ValueError, match="float32"):
        relax_sweep_(labels.double(), on_card)
    with pytest.raises(ValueError, match="contiguous"):
        relax_sweep_(t(dist).to(cuda_device).t(), on_card)
    with pytest.raises(ValueError, match="nodes"):
        relax_sweep_(labels[:10], on_card)
    with pytest.raises(ValueError, match="the sweep is on"):
        relax_sweep_(labels, pack_sweep([(dst, src, w, valid)], 11))


# ------------------------------------------------- the store-backed engine
_STORES = {}


def _small_store(tmp_path_factory):
    """A road-grid index (900 nodes) and its raw block store, built once
    on the CPU: (store path, index)."""
    if not _STORES:
        from repro_torch.core import (BuildConfig, build_hod_fast,
                                      grid_road_graph, pack_index)
        g = grid_road_graph(30, seed=1)
        res = build_hod_fast(g, BuildConfig(max_core_nodes=64,
                                            max_core_edges=4096))
        ix = pack_index(g, res, chunk=256, k_cap=16, closure_limit=4096,
                        device="cpu")
        path = str(tmp_path_factory.mktemp("store") / "raw")
        ix.save_store(path, block_bytes=4096)
        _STORES["raw"] = (path, ix)
    return _STORES["raw"]


def _stream_engine(path, device, cache_bytes=None, **kw):
    from repro_torch.storage import (IndexStore, PageCache,
                                     StreamingQueryEngine)
    return StreamingQueryEngine(IndexStore(path,
                                           cache=PageCache(cache_bytes)),
                                device=device, **kw)


@pytest.mark.cuda
def test_pinned_stager_waits_for_its_copies(cuda_device):
    """Levels staged while the stream is held by a long kernel: a buffer
    refilled before its copy ran would hand the card another level's
    bytes."""
    from repro_torch.kernels.edge_relax.sweep import PinnedStager
    stager = PinnedStager(cuda_device)
    torch.cuda._sleep(100_000_000)          # hold the stream ~50 ms
    staged = [stager.stage([np.full(4099, i, np.int32),
                            np.full((3, 5), i, np.float32)])
              for i in range(8)]
    for i, (a, b) in enumerate(staged):
        assert (a == i).all().item() and (b == i).all().item()
    assert stager.copies == 8 and stager.wait_s > 0
    assert all(b.is_pinned() for b in stager._bufs)


@pytest.mark.cuda
def test_streaming_engine_on_card_equals_cpu(cuda_device, tmp_path_factory):
    """24 batches at a page cache of 0 bytes (every level misses, so
    every level is read, packed and copied anew) through the pinned
    double buffer: the card's answers equal the CPU engine's."""
    path, ix = _small_store(tmp_path_factory)
    gpu = _stream_engine(path, cuda_device, 0, queue_depth=4)
    cpu = _stream_engine(path, "cpu", 0, prefetch=False)
    try:
        rng = np.random.default_rng(0)
        for i in range(24):
            src = rng.integers(0, ix.n, 32).astype(np.int32)
            np.testing.assert_array_equal(gpu.ssd(src), cpu.ssd(src))
            if i % 6 == 0:
                for a, b in zip(gpu.sssp(src), cpu.sssp(src)):
                    np.testing.assert_array_equal(a, b)
        assert gpu.store.cache.stats.hits == 0
        assert all(b is not None and b.is_pinned()
                   for b in gpu._stager._bufs)
    finally:
        gpu.close()
        cpu.close()


@pytest.mark.cuda
def test_edge_relax_launches_once_a_streamed_level(cuda_device,
                                                   tmp_path_factory):
    path, ix = _small_store(tmp_path_factory)
    eng = _stream_engine(path, cuda_device)
    try:
        levels = 0
        for plan in (ix.plan_f, ix.plan_b):
            for lvl in np.flatnonzero(plan.level_mask):
                keep = plan.row_valid[lvl][:, None] \
                    & np.isfinite(plan.w[lvl])
                levels += bool(keep.any())
        assert levels == eng.store.n_real("plan_f") \
            + eng.store.n_real("plan_b")
        src = np.arange(16, dtype=np.int32)
        before, copies = relax_sweep_.launches, eng._stager.copies
        eng.ssd(src)
        assert relax_sweep_.launches - before == levels
        assert eng._stager.copies - copies == levels
        assert eng.times.levels == levels
    finally:
        eng.close()


# ------------------------------------------------ the async server, traced
def _mixed_async(server, stream):
    """Submit a mixed stream on a frozen scheduler clock (only the size
    triggers and the drain flush, so batching does not depend on the
    device's speed), then drain; the results in order."""
    import asyncio
    server._now = lambda: 0.0

    async def drive():
        tasks = []
        for lo in range(0, len(stream), 5):
            tasks += [asyncio.create_task(server.submit(*args, mode=m))
                      for m, args in stream[lo:lo + 5]]
            await asyncio.sleep(0)
        await server.drain()
        return await asyncio.gather(*tasks)
    return asyncio.run(drive())


@pytest.mark.cuda
@pytest.mark.parametrize("scheduler", ["fifo", "slo"])
def test_async_mixed_server_on_card_equals_cpu(cuda_device,
                                               tmp_path_factory,
                                               scheduler):
    """The mixed ssd/p2p/within server under each scheduler, in memory
    and from the store, on the card: every answer, batch and cache hit
    equals the same server's on the CPU."""
    from repro_torch.config import SERVE_DEFAULTS, Config
    from repro_torch.core import QueryEngine
    from repro_torch.launch.serve import (mixed_request_stream,
                                          server_from_config)
    path, ix = _small_store(tmp_path_factory)
    cfg = Config(None, defaults=SERVE_DEFAULTS, overrides={"serve": {
        "batch": 16, "max_wait_ms": 5000.0, "scheduler": scheduler,
        "threshold": 20.0, "cache_entries": 64,
        "mix": {"ssd": 1, "p2p": 3, "within": 1},
        "slo": {"p2p": {"deadline_ms": 5000.0, "batch": 8},
                "ssd": {"deadline_ms": 20000.0}}}})
    stream = mixed_request_stream(cfg, ix.n, 120,
                                  np.random.default_rng(0), p2p_pool=12)
    for store in (False, True):
        runs = []
        for dev in (cuda_device, "cpu"):
            if store:
                server = server_from_config(
                    cfg, store_path=path, cache_bytes=200_000,
                    engine_opts={"device": dev})
            else:
                server = server_from_config(
                    cfg, engine=QueryEngine(ix, device=dev))
            try:
                server.warmup()
                runs.append((_mixed_async(server, stream), server.stats,
                             server.slo_report()))
            finally:
                server.close()
        (gpu, gst, grows), (cpu, cst, crows) = runs
        for a, b in zip(gpu, cpu):
            assert (a.mode, a.source, a.target, a.cached, a.batched_with) \
                == (b.mode, b.source, b.target, b.cached, b.batched_with)
            np.testing.assert_array_equal(a.dist, b.dist)
        for f in ("requests", "batches", "cache_hits", "padded_slots",
                  "page_hits", "page_misses", "store_bytes_read"):
            assert getattr(gst, f) == getattr(cst, f), f
        assert [r["requests"] for r in grows] \
            == [r["requests"] for r in crows]
        assert gst.cache_hits > 0


@pytest.mark.cuda
def test_traced_store_server_on_card(cuda_device, tmp_path_factory):
    """A traced store server on the card: a valid Chrome trace holding
    the pipeline, level, core and cache events, the same answers and
    counters as untraced, and the same query-thread span sequence at
    queue depths 1 and 4."""
    import threading

    from repro_torch.launch.serve import QueryServer
    from repro_torch.obs import Tracer, validate_chrome_trace
    path, ix = _small_store(tmp_path_factory)
    me = threading.current_thread().name
    rng = np.random.default_rng(4)
    reqs = rng.choice(rng.choice(ix.n, 24, replace=False),
                      64).astype(np.int32)
    out = {}
    for depth, traced in ((4, True), (4, False), (1, True)):
        tr = Tracer() if traced else None
        server = QueryServer(store_path=path, cache_bytes=200_000,
                             batch_size=16, queue_depth=depth, tracer=tr,
                             engine_opts={"device": cuda_device},
                             warm_start=True)
        try:
            res = server.serve_stream(reqs)
            cs = server.store.cache.stats
            out[depth, traced] = (
                [r.dist for r in res], server.stats.cache_hits,
                (cs.hits, cs.misses, cs.evictions, cs.bytes_read),
                tr.sequence(me) if tr else None)
        finally:
            server.close()
        if traced:
            assert validate_chrome_trace(tr.chrome()) == []
            names = {e["name"] for e in tr.events()}
            assert {"query.ssd", "jit.dispatch", "pipe.submit",
                    "level.read", "level.wait", "level.relax",
                    "core.search", "cache.miss", "device.read"} <= names
    (d4, h4, c4, s4), (u4, uh, uc, _), (d1, h1, c1, s1) = (
        out[4, True], out[4, False], out[1, True])
    for a, b, c in zip(d4, u4, d1):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert h4 == uh == h1 and c4 == uc == c1
    assert s4 == s1


# ------------------------------------------------------------- the fleet
def _delta_store(tmp_path_factory):
    """The small road-grid index as a delta store: (store path, index)."""
    if "delta" not in _STORES:
        _, ix = _small_store(tmp_path_factory)
        path = str(tmp_path_factory.mktemp("store") / "delta")
        ix.save_store(path, block_bytes=4096, codec="delta")
        _STORES["delta"] = (path, ix)
    return _STORES["delta"]


@pytest.mark.cuda
def test_two_shard_delta_fleet_on_card_equals_unsharded(cuda_device,
                                                        tmp_path_factory):
    """A 2-shard fleet over a delta store serves on the card: every
    batch bit-equal to the unsharded store engine's, one edge_relax
    launch a streamed level, per-shard bytes summing to the fleet's."""
    from repro_torch.fleet import ServingFleet
    from repro_torch.storage import StreamingQueryEngine
    path, ix = _delta_store(tmp_path_factory)
    fleet = ServingFleet(path, 2, cache_bytes=150_000)
    feng = StreamingQueryEngine(fleet.store, device=cuda_device)
    solo = _stream_engine(path, cuda_device, 150_000)
    levels = feng.store.n_real("plan_f") + feng.store.n_real("plan_b")
    try:
        rng = np.random.default_rng(2)
        for _ in range(8):
            src = rng.integers(0, ix.n, 32).astype(np.int32)
            before = relax_sweep_.launches
            got = feng.ssd(src)
            assert relax_sweep_.launches - before == levels
            np.testing.assert_array_equal(got, solo.ssd(src))
        st = fleet.stats()
        assert len(st.rows) == 2 and st.cache.misses > 0
        assert sum(r["bytes_read"] for r in st.rows) == st.cache.bytes_read
    finally:
        feng.close()
        solo.close()
    assert fleet._workers_down


@pytest.mark.cuda
def test_corrupt_segment_raises_through_the_shard_workers(
        cuda_device, tmp_path_factory, tmp_path):
    """A CRC mismatch decoded on a shard's pool raises in the querying
    thread on the card, twice (the placeholder is discarded)."""
    import os
    import shutil

    from repro_torch.fleet import ServingFleet
    from repro_torch.storage import StreamingQueryEngine
    src_path, _ = _delta_store(tmp_path_factory)
    path = str(tmp_path / "store")
    shutil.copytree(src_path, path)
    with open(os.path.join(path, "plan_f.seg"), "r+b") as f:
        f.seek(2 * 4096 + 100)
        f.write(b"\xde\xad\xbe\xef" * 8)
    fleet = ServingFleet(path, 2)
    eng = StreamingQueryEngine(fleet.store, device=cuda_device)
    try:
        for _ in range(2):
            with pytest.raises(ValueError, match="CRC mismatch"):
                eng.ssd(np.arange(4, dtype=np.int32))
    finally:
        eng.close()


@pytest.mark.cuda
@pytest.mark.parametrize("module", ["repro_torch.storage.smoke",
                                    "repro_torch.fleet.smoke"])
def test_smoke_runs_on_card(cuda_device, module):
    """``python -m repro_torch.{storage,fleet}.smoke`` on the card."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run([sys.executable, "-m", module], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "smoke OK on cuda" in out.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("arch,shape,repl", [
    ("gcn-cora", "full_graph_sm", {}),
    ("gcn-cora", "full_graph_sm", {"edge_chunk": 33}),
    ("gcn-cora", "molecule", {"edge_layout": "partitioned",
                              "edge_chunk": 40}),
    ("gin-tu", "minibatch_lg", {}),
    ("gin-tu", "molecule", {"edge_chunk": 50}),
    ("schnet", "molecule", {}),
    ("schnet", "ogb_products", {"edge_chunk": 33}),
    ("equiformer-v2", "molecule", {}),
    ("equiformer-v2", "full_graph_sm", {"edge_chunk": 33}),
])
def test_gnn_forward_backward_on_card(cuda_device, arch, shape, repl):
    """Each GNN's smoke cell, plain and chunked (sentinel-padded chunks,
    index_add_'s atomics), on the card against the CPU: loss rtol 1e-5,
    each gradient leaf rtol 1e-4 with atol 1e-5 of its largest magnitude
    (f32 sums in another order)."""
    import dataclasses

    from repro_torch.launch.steps import GNN_MODULES, build_cell, value_and_grad
    from repro_torch.tree import flatten_with_paths, leaves, map_tree
    cell = build_cell(arch, shape, smoke=True, device="cpu")
    cfg = dataclasses.replace(cell.meta["cfg"], **repl)
    model, params, g = GNN_MODULES[arch], cell.args[0]["params"], cell.args[1]
    want_loss, want = value_and_grad(lambda p: model.loss_fn(p, g, cfg),
                                     params)
    gc = g.to(cuda_device)
    loss, grads = value_and_grad(
        lambda p: model.loss_fn(p, gc, cfg),
        map_tree(lambda t: t.to(cuda_device), params))
    assert abs(loss.item() - want_loss.item()) <= 1e-5 * abs(want_loss.item())
    for (k, got), w in zip(flatten_with_paths(grads), leaves(want)):
        assert got.device.type == "cuda", k
        torch.testing.assert_close(got.cpu(), w, rtol=1e-4,
                                   atol=1e-5 * w.abs().max().item(), msg=k)


def _moe_inputs(gen, t, d, e, f, dtype):
    x = torch.randn((1, t, d), generator=gen)
    router = torch.randn((d, e), generator=gen) * d ** -0.5
    wg, wu = (torch.randn((e, d, f), generator=gen) * d ** -0.5
              for _ in range(2))
    wd = torch.randn((e, f, d), generator=gen) * f ** -0.5
    return [a.to(dtype) for a in (x, router, wg, wu, wd)]


@pytest.mark.cuda
@pytest.mark.parametrize("t,d,e,k,f,cf", [
    (128, 64, 8, 2, 32, 1.25), (128, 64, 8, 2, 32, 0.5),
    (32, 1024, 32, 8, 512, 1.25),            # granite-moe's decode_32k
    (8, 2048, 128, 8, 768, 1.25)])           # qwen3-moe's decode_32k
def test_moe_block_on_card(cuda_device, t, d, e, k, f, cf):
    """The MoE block on the card against the CPU: the same routing and
    drops, f32 within atol 1e-5 of the largest output; in bf16 two runs
    bit-equal (the combine adds in a fixed order, no atomics) and no
    host sync (``set_sync_debug_mode("error")``)."""
    from repro_torch.models import layers as tl
    cfg = tl.MoEConfig(e, k, f, capacity_factor=cf)
    gen = torch.Generator().manual_seed(t + e)
    cpu = _moe_inputs(gen, t, d, e, f, torch.float32)
    on = [a.to(cuda_device) for a in cpu]
    want, want_aux = tl.moe_block(*cpu, cfg)
    got, aux = tl.moe_block(*on, cfg)
    r_cpu = tl.moe_route(cpu[0][0], cpu[1], cfg)
    r_card = tl.moe_route(on[0][0], on[1], cfg)
    for name in ("expert", "slot", "keep"):
        assert torch.equal(getattr(r_card, name).cpu(),
                           getattr(r_cpu, name)), name
    torch.testing.assert_close(got.cpu(), want, rtol=0,
                               atol=1e-5 * want.abs().max().item())
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-6, atol=0)
    bf = [a.to(torch.bfloat16) for a in on]
    first, _ = tl.moe_block(*bf, cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        second, _ = tl.moe_block(*bf, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("cur_len", [5, 1023, 1024, 1500, 524287])
def test_rolling_decode_dh256_on_card(cuda_device, cur_len):
    """gemma3's local layer at its published head layout (16 heads, 8 KV
    heads, dh 256: the SIMT form) over a 1024-slot rolling cache: the
    new K/V at slot cur_len % 1024, flash_decode over the valid slots,
    against its plain version within atol 1e-4."""
    from repro_torch.models import layers as tl
    w = 1024
    gen = torch.Generator(device=cuda_device).manual_seed(cur_len)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device,
                           dtype=torch.bfloat16)
    q, kc, vc, kn, vn = (rand(2, 16, 256), rand(2, w, 8, 256),
                         rand(2, w, 8, 256), rand(2, 8, 256),
                         rand(2, 8, 256))
    before = flash_decode.launches
    out, k2, v2 = tl.attention_decode(q, kc, vc, kn, vn, cur_len, window=w)
    assert flash_decode.launches == before + 1 and k2 is kc
    assert torch.equal(kc[:, cur_len % w], kn)
    want = flash_decode_ref(q, kc, vc, min(cur_len, w - 1) + 1)
    torch.testing.assert_close(out.float(), want.to(torch.bfloat16).float(),
                               atol=1e-2, rtol=1e-2)
    raw = flash_decode(q, kc, vc, min(cur_len, w - 1) + 1)
    np.testing.assert_allclose(raw.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "gemma3-12b"])
def test_family_decode_step_on_card(cuda_device, arch):
    """A decode step of the smoke config on the card equals the CPU's
    within atol 1e-4 in f32, launches flash_decode once a layer, and
    makes no host sync (after a first step that builds the kernel)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf
    from repro_torch.tree import map_tree
    cfg = dataclasses.replace(get_arch(arch).smoke_config(),
                              compute_dtype=torch.float32)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    want, caches = tf.prefill(params, toks, cfg)
    on = map_tree(lambda a: a.to(cuda_device), params)
    got, card_caches = tf.prefill(on, toks.to(cuda_device), cfg)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)
    nxt = want.argmax(-1)
    full = tf.make_cache(cfg, 2, 48, dtype=torch.float32, device="cpu")
    for f, part in zip(full, caches):
        f["k"][:, :, :40] = part["k"]
        f["v"][:, :, :40] = part["v"]
    card_full = map_tree(lambda a: a.to(cuda_device), full)
    card_nxt = nxt.to(cuda_device)
    want, _ = tf.decode_step(params, full, nxt, 40, cfg)
    tf.decode_step(on, map_tree(lambda a: a.clone(), card_full), card_nxt,
                   40, cfg)
    torch.cuda.synchronize()
    before = flash_decode.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, _ = tf.decode_step(on, card_full, card_nxt, 40, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert flash_decode.launches == before + cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)
