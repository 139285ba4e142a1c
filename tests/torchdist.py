"""Run a function on every rank of a gloo group, for the port's
distributed tests (CPU only).

:func:`run_ranks` spawns ``world`` processes (the ``spawn`` start
method: a fresh interpreter each), joins them in one gloo group over a
``file://`` rendezvous, and calls ``body(rank, world, payload)`` on each;
``body`` is named ``"module:function"`` and imported in the child, so
it must live in a module that imports no JAX (``torchdist_bodies``).
Each child checks at its end that it imported neither ``jax`` nor
``repro``.  The parent collects every rank's result with a deadline:
it re-raises the first rank's traceback, and kills every process still
alive when it returns or raises (a rank that raised leaves the others
blocked in a collective, and the group's 60 s timeout would be late).
A world of one runs in this process instead, in a group of its own.
:class:`Ranks` starts the ranks and collects them later, so that a
test module can compute its references while they run.
"""
import contextlib
import datetime
import importlib
import multiprocessing
import os
import queue
import sys
import tempfile
import time
import traceback

#: A collective that waits longer than this fails in the child.
GROUP_TIMEOUT = datetime.timedelta(seconds=60)


@contextlib.contextmanager
def one_thread():
    """torch's intra-op pool at one thread for the block, restored after:
    these tests run many small ops, and beside the other test workers a
    pool as wide as the machine spends its time waiting on its own
    threads."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _one_rank(body, payload):
    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "gloo", init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
            rank=0, world_size=1, timeout=GROUP_TIMEOUT)
        try:
            mod, fn = body.split(":")
            return getattr(importlib.import_module(mod), fn)(0, 1, payload)
        finally:
            dist.destroy_process_group()


def _entry(rank, world, init, body, payload, out, path):
    sys.path[:0] = [p for p in path if p not in sys.path]
    try:
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)        # ranks share the machine's cores
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=world, timeout=GROUP_TIMEOUT)
        try:
            mod, fn = body.split(":")
            value = getattr(importlib.import_module(mod), fn)(
                rank, world, payload)
        finally:
            dist.destroy_process_group()
        leaked = [m for m in ("jax", "repro") if m in sys.modules]
        if leaked:
            raise RuntimeError(f"rank {rank} imported {leaked}")
        out.put((rank, True, value))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))


class Ranks:
    """``body(rank, world, payload)`` started on ``world`` gloo ranks;
    :meth:`results` collects them, so the caller may work meanwhile
    (the ranks wait on each other more than they compute).  The deadline
    runs from the start; :meth:`close` kills whatever is still alive."""

    def __init__(self, world, body, payload=None, timeout=60.0):
        ctx = multiprocessing.get_context("spawn")
        self.world, self.body, self.timeout = world, body, timeout
        self._out = ctx.Queue()
        self._tmp = tempfile.TemporaryDirectory()
        init = f"file://{os.path.join(self._tmp.name, 'rendezvous')}"
        self._procs = [ctx.Process(target=_entry,
                                   args=(r, world, init, body, payload,
                                         self._out, list(sys.path)),
                                   daemon=True)
                       for r in range(world)]
        for p in self._procs:
            p.start()
        self._deadline = time.monotonic() + timeout
        self._results = None

    def results(self):
        """Every rank's result in rank order (the first call waits)."""
        if self._results is not None:
            return self._results
        world, procs, results = self.world, self._procs, {}
        try:
            while len(results) < world:
                left = self._deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{self.body} on {world} ranks: ranks "
                        f"{sorted(set(range(world)) - set(results))} gave "
                        f"no result in {self.timeout:.0f} s")
                try:
                    rank, ok, value = self._out.get(timeout=min(left, 0.5))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in results and p.exitcode not in
                            (None, 0)]
                    if dead:
                        raise RuntimeError(
                            f"{self.body}: rank {dead[0]} died (exit code "
                            f"{procs[dead[0]].exitcode})") from None
                    continue
                if not ok:
                    raise RuntimeError(
                        f"{self.body}: rank {rank} of {world} raised:\n"
                        f"{value}")
                results[rank] = value
        finally:
            self.close(wait=5.0)
        self._results = [results[r] for r in range(world)]
        return self._results

    def close(self, wait=0.0):
        """Kill every rank still alive after ``wait`` seconds each."""
        for p in self._procs:
            p.join(timeout=wait)
            if p.is_alive():
                p.kill()
                p.join()
        self._tmp.cleanup()


def run_ranks(world, body, payload=None, timeout=60.0):
    """``body(rank, world, payload)`` on ``world`` gloo ranks; the ranks'
    results in rank order.  One rank runs in this process, in a group
    of its own (no spawn to pay for)."""
    if world == 1:
        return [_one_rank(body, payload)]
    return Ranks(world, body, payload, timeout).results()
