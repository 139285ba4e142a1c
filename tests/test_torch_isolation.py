"""The port stands alone: it never imports JAX or the JAX package, and
it never carries on on the CPU when the card it defaults to is missing."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.core as T

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_import_loads_neither_jax_nor_repro():
    code = ("import sys\n"
            "import repro_torch, repro_torch.core, repro_torch.launch.serve\n"
            "import repro_torch.kernels.edge_relax\n"
            "import repro_torch.kernels.tropical_matmul\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={"PYTHONPATH": str(ROOT / "src")}, cwd=str(ROOT),
                   timeout=120)


def test_engine_defaults_to_the_card():
    g = T.gnm_random_digraph(150, 600, seed=9)
    res = T.build_hod_fast(g, T.BuildConfig(max_core_nodes=32,
                                            max_core_edges=1024))
    ix = T.pack_index(g, res, chunk=16, device="cpu")
    assert ix.n_core > 0          # pack_index closes the core on a device
    if torch.cuda.is_available():
        assert T.QueryEngine(ix).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.QueryEngine(ix)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.pack_index(g, res, chunk=16)
    eng = T.QueryEngine(ix, device="cpu")
    np.testing.assert_array_equal(eng.ssd(np.array([0, 149])),
                                  T.dijkstra_reference(g, [0, 149]))
