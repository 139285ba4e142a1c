"""Rank-side bodies of the sharded checkpoint tests
(``tests/test_torch_sharded_ckpt.py``) and of the train CLI on a mesh
(``tests/test_torch_train_mesh.py``).  This module imports the port and
torch only, never JAX: every rank imports it.  The bodies return plain
Python values; the files they write are read by the parent, which holds
them to the unsharded saves and to the JAX package.

Every rank makes every mesh of the payload first (``make_mesh`` is
collective over the whole group), then runs the cases of the meshes it
belongs to, in order.  A case's directories come from the payload; the
rank at mesh index 0 writes what one rank writes.
"""
import contextlib
import io

#: The smoke train cells of the two files.
CELLS = {"glm4-9b": "train_4k", "gcn-cora": "full_graph_sm",
         "dlrm-rm2": "train_batch"}


def _rules(mesh, arch):
    from repro_torch import shardlib as sl
    from repro_torch.launch import steps
    return sl.axis_rules(mesh, steps.rules_for(arch, CELLS[arch], mesh))


def _cell(mesh, arch, stepped, draw=True):
    """``arch``'s smoke train cell under its rules on ``mesh``; with
    ``stepped``, one step taken (m, v and the count nonzero); without
    ``draw``, its state undrawn."""
    from repro_torch.launch import steps
    with _rules(mesh, arch):
        cell = steps.build_cell(arch, CELLS[arch], smoke=True, device="cpu",
                                draw=draw)
        if stepped:
            cell.fn(cell.args[0], *cell.batch_at(0))
    return cell


def _bf16_params(state, shardings):
    """The state's parameters cast to bf16, and their shardings."""
    import torch

    from repro_torch.tree import map_tree
    return ({"params": map_tree(lambda t: t.to(torch.bfloat16),
                                state["params"])},
            {"params": shardings["params"]})


def save_case(mesh, arch, d):
    """A sharded save of the stepped cell's state (the manager, async)
    into ``d["sharded"]`` and of its bf16 parameters (``save_pytree``)
    into ``d["bf16"]``; the rank at mesh index 0 saves the gathered
    trees whole into ``d["whole"]`` and ``d["whole_bf16"]``."""
    from repro_torch import shardlib as sl
    from repro_torch.checkpoint import CheckpointManager, save_pytree
    from repro_torch.tree import map_tree
    cell = _cell(mesh, arch, stepped=True)
    state, sh = cell.args[0], cell.in_shardings[0]
    mgr = CheckpointManager(d["sharded"], async_write=True)
    mgr.save(1, state, shardings=sh)
    mgr.wait()
    half, half_sh = _bf16_params(state, sh)
    save_pytree(half, d["bf16"], {"step": 1}, shardings=half_sh)
    with _rules(mesh, arch):
        whole = map_tree(lambda t, s: sl.gather_blocks(t, s.spec), state, sh)
    if sl.mesh_index(mesh) == 0:
        save_pytree(whole, d["whole"], {"step": 1})
        save_pytree(_bf16_params(whole, sh)[0], d["whole_bf16"],
                    {"step": 1})


def restore_case(mesh, arch, d):
    """The sharded saves of ``d`` restored onto ``mesh`` by blocks (the
    state through the manager, which agrees on the step; the bf16
    parameters through ``load_pytree``), each block against
    ``local_block`` of the whole leaf: the keys that differ."""
    import torch

    from repro_torch import shardlib as sl
    from repro_torch.checkpoint import CheckpointManager, load_pytree
    from repro_torch.tree import flatten_with_paths
    cell = _cell(mesh, arch, stepped=False)
    like, sh = cell.args[0], cell.in_shardings[0]
    got, extra = CheckpointManager(d["sharded"]).restore(like, shardings=sh)
    whole, _ = load_pytree(d["whole"], like)
    half_like, half_sh = _bf16_params(like, sh)
    got_half, _ = load_pytree(d["bf16"], half_like, shardings=half_sh)
    whole_half, _ = load_pytree(d["whole_bf16"], half_like)
    differ, n = [], 0
    for g_tree, w_tree, s_tree in ((got, whole, sh),
                                   (got_half, whole_half, half_sh)):
        specs = dict(flatten_with_paths(s_tree))
        for (k, g), (_, w) in zip(flatten_with_paths(g_tree),
                                  flatten_with_paths(w_tree)):
            want = sl.local_block(w, specs[k].spec, mesh)
            n += 1
            if g.dtype != want.dtype or g.shape != want.shape \
                    or not torch.equal(g, want):
                differ.append(k)
    return {"differ": differ, "n": n, "step": extra["step"]}


def corrupt_case(mesh, arch, d):
    """One flipped byte in one leaf of a copy of ``d["sharded"]``'s step
    (the largest leaf whose CRC another rank than the flipping one
    checks): every rank's restore raises ``IOError``.  Returns (the
    flipped leaf's key, the rank's error text)."""
    import json
    import math
    import os
    import shutil

    import torch.distributed as dist

    from repro_torch import shardlib as sl
    from repro_torch.checkpoint import load_pytree, manager
    cell = _cell(mesh, arch, stepped=False)
    src = os.path.join(d["sharded"], "step_00000001")
    with open(os.path.join(src, "manifest.json")) as f:
        recs = json.load(f)["leaves"]
    sizes = [math.prod(r["shape"]) * manager._itemsize(r["dtype"])
             for r in recs]
    owner = manager._crc_owners(sizes, mesh.size())
    leaf = max((i for i in range(len(recs)) if owner[i] != 0),
               key=lambda i: sizes[i])
    if sl.mesh_index(mesh) == 0:
        shutil.copytree(src, d["corrupt"])
        with open(os.path.join(d["corrupt"], recs[leaf]["file"]),
                  "r+b") as f:
            f.seek(-7, os.SEEK_END)
            b = f.read(1)
            f.seek(-7, os.SEEK_END)
            f.write(bytes([b[0] ^ 0x10]))
    dist.barrier(group=sl.mesh_group(mesh))
    try:
        load_pytree(d["corrupt"], cell.args[0],
                    shardings=cell.in_shardings[0])
    except IOError as e:
        return recs[leaf]["key"], str(e)
    return recs[leaf]["key"], None


def crash_case(mesh, arch, d):
    """Step 1 saved, then step 2's save with the writes of the rank at
    mesh index 1 failing: every rank raises, step 1 stays the latest,
    and neither step 2 nor its ``.tmp`` is left."""
    import os

    from repro_torch import shardlib as sl
    from repro_torch.checkpoint import CheckpointManager, manager
    cell = _cell(mesh, arch, stepped=True)
    state, sh = cell.args[0], cell.in_shardings[0]
    mgr = CheckpointManager(d["crash"], async_write=True)
    mgr.save(1, state, shardings=sh)
    mgr.wait()
    write = manager._ShardedSave.write
    if sl.mesh_index(mesh) == 1:
        def fail(self):
            raise OSError("injected write failure")
        manager._ShardedSave.write = fail
    raised = None
    try:
        mgr.save(2, state, shardings=sh)
        mgr.wait()
    except OSError as e:
        raised = f"{type(e).__name__}: {e}"
    finally:
        manager._ShardedSave.write = write
    return {"raised": raised, "latest": mgr.latest_step(mesh),
            "left": sorted(os.listdir(d["crash"]))}


def memory_case(mesh, d):
    """A 32 MiB f32 leaf ``[2048, 4096]`` cut by columns over ``model``:
    saved by blocks, then restored by blocks under ``tracemalloc``.
    Returns (the restore's traced peak in bytes, whether the block is
    ``local_block`` of the whole)."""
    import tracemalloc

    import numpy as np
    import torch

    from repro_torch import shardlib as sl
    from repro_torch.checkpoint import load_pytree, save_pytree
    whole = torch.from_numpy(np.random.default_rng(27).normal(
        size=(2048, 4096)).astype(np.float32))
    sh = {"w": sl.NamedSharding(mesh, sl.P(None, "model"))}
    save_pytree({"w": sl.local_block(whole, sh["w"].spec, mesh)}, d["big"],
                {"step": 0}, shardings=sh)
    like = {"w": whole[:, :1]}
    tracemalloc.start()
    try:
        got, _ = load_pytree(d["big"], like, shardings=sh)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    return {"peak": peak, "bytes": whole.numel() * 4,
            "equal": torch.equal(got["w"], sl.local_block(
                whole, sh["w"].spec, mesh))}


def ckpt_battery(rank, world, p):
    """The payload's stages on this rank, in order: ``p["stages"]``
    lists ``(mesh shape, ranks, cases)``; a case is ``(kind, arch,
    dirs)`` with kind ``save``, ``restore``, ``corrupt`` or ``crash``,
    or ``("memory", None, dirs)``.  Returns ``{(stage, i): result}`` for
    the cases of this rank's meshes."""
    from repro_torch import shardlib as sl
    meshes = {}
    for shape, ranks, _ in p["stages"]:
        if (shape, ranks) not in meshes:
            meshes[shape, ranks] = sl.make_mesh(shape, ("data", "model"),
                                                "cpu", ranks=ranks)
    out = {}
    bodies = {"save": save_case, "restore": restore_case,
              "corrupt": corrupt_case, "crash": crash_case}
    for j, (shape, ranks, cases) in enumerate(p["stages"]):
        mesh = meshes[shape, ranks]
        if mesh is None:
            continue
        for i, (kind, arch, dirs) in enumerate(cases):
            out[j, i] = (memory_case(mesh, dirs) if kind == "memory"
                         else bodies[kind](mesh, arch, dirs))
    return out


# ---------------------------------------------------------------------------
# the train CLI on a mesh
# ---------------------------------------------------------------------------

def cli_runs(rank, world, p):
    """``elastic_case`` with ``p["elastic"]``, if given; then
    ``launch.train.main`` on this rank for each ``(name, argv, source)``
    of ``p["runs"]`` in turn, the rank 0 first copying the checkpoint
    directory ``source`` (if any) to the run's ``--ckpt-dir`` once its
    step ``p["ready"][source]`` is there (the parent, or another group,
    may still be writing it).  Returns ``{name: (result, rank 0's
    log)}``, and the elastic case's result under ``"elastic"``."""
    import os
    import shutil
    import time

    import torch.distributed as dist

    from repro_torch.launch import train
    out = {}
    if "elastic" in p:
        out["elastic"] = elastic_case(rank, world, p["elastic"])
    for name, argv, source in p["runs"]:
        if source is not None:
            if rank == 0:
                ready = os.path.join(source, p["ready"][source])
                deadline = time.monotonic() + 120.0
                while not os.path.isdir(ready):
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{ready} never came")
                    time.sleep(0.05)
                shutil.copytree(source, argv[argv.index("--ckpt-dir") + 1])
            dist.barrier()
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            res = train.main(argv)
        out[name] = (res, log.getvalue())
    return out


def elastic_case(rank, world, p):
    """gcn-cora's smoke cell under ``ElasticTrainer`` with ``shardings``:
    ``p["steps"]`` steps, checkpoints every ``p["every"]``, and a
    ``DeviceLoss(p["survivors"])`` before step ``p["fail"]``.  The mesh
    is re-cut onto the survivors and the state restored onto it by
    blocks: the cell that gives the shardings is built undrawn, and a
    state is drawn only where no checkpoint is restored.  Returns the
    log, and on a rank of the last mesh the final parameters gathered
    whole (numpy); None on a rank outside it."""
    from repro_torch import shardlib as sl
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.ft import DeviceLoss, ElasticTrainer
    from repro_torch.optim import OptState
    from repro_torch.tree import leaves, map_tree
    arch = "gcn-cora"
    cells = {}

    def shardings(mesh):
        cells["now"] = _cell(mesh, arch, stepped=False, draw=False)
        return cells["now"].in_shardings[0]

    def build(n_devices, restored):
        cell = cells["now"]
        state = (_cell(trainer.mesh, arch, stepped=False).args[0]
                 if restored is None else
                 {"params": restored["params"],
                  "opt": OptState(**restored["opt"])})

        def step_fn(st, step):
            with _rules(trainer.mesh, arch):
                return cell.fn(st, *cell.batch_at(step))[0]
        return state, step_fn

    failed = []

    def injector(step):
        if step == p["fail"] and not failed:
            failed.append(step)
            raise DeviceLoss(p["survivors"])
    trainer = ElasticTrainer(
        ckpt=CheckpointManager(p["dir"], keep_last=2), build=build,
        total_steps=p["steps"], ckpt_every=p["every"],
        failure_injector=injector, shardings=shardings)
    state, log = trainer.run(world)
    if state is None:
        return {"state": None, "log": log}
    sh = cells["now"].in_shardings[0]
    with _rules(trainer.mesh, arch):
        whole = map_tree(lambda t, s: sl.gather_blocks(t, s.spec),
                         state["params"], sh["params"])
    return {"log": log, "count": int(state["opt"].count),
            "params": [t.numpy() for t in leaves(whole)]}
