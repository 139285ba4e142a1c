"""Shared pieces of the benchmark's CPU tests: the real benchmark with
its cells cut to a CPU's size."""
from pathlib import Path

import torch

from hodbench import spec

# The CPU rehearsals time half-second windows; a thread pool as wide as
# the machine stalls on a busy CPU, so the tests run the port on one.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[2]

#: Graph sizes a CPU test run holds, by generator kind.
SMALL = {"grid_road": {"side": 12}, "power_law": {"n": 200}}


def small_cell(name: str, root: Path = ROOT, bench: dict = None):
    """``(bench, cell)``: the cell as its files say, at a CPU test's size
    (the graph's scale and the plan chunk cut, nothing else)."""
    bench = spec.load(root) if bench is None else bench
    cell = spec.cell(root, bench, name)
    cell.config["graph"].update(SMALL[cell.config["graph"]["kind"]])
    cell.config["pack"]["chunk"] = 64
    return bench, cell
