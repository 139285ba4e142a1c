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
    + [ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))


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
            "import repro_torch.kernels.flash_decode\n"
            "import repro_torch.kernels.embedding_bag\n"
            "import repro_torch.configs, repro_torch.launch.steps\n"
            "import repro_torch.models.layers, repro_torch.models.transformer\n"
            "import repro_torch.models.dlrm, repro_torch.models.common\n"
            "import repro_torch.models.init\n"
            "import repro_torch.models.convert\n"
            "import repro_torch.storage, repro_torch.storage.stream\n"
            "import repro_torch.storage.pipeline\n"
            "import repro_torch.config, repro_torch.obs.trace\n"
            "import repro_torch.fleet, repro_torch.fleet.smoke\n"
            "import repro_torch.core.baselines, repro_torch.storage.smoke\n"
            "from repro_torch.core import build_hod, em_dijkstra\n"
            "from repro_torch.fleet import ServingFleet, StorePartition\n"
            "from repro_torch.core import topk_closeness\n"
            "from repro_torch.launch.serve import server_from_config\n"
            "from repro_torch.storage import StreamingQueryEngine\n"
            "from repro_torch.configs import get_arch\n"
            "get_arch('glm4-9b'), get_arch('dlrm-rm2')\n"
            "import repro_torch.optim, repro_torch.data, repro_torch.tree\n"
            "import repro_torch.checkpoint, repro_torch.ft\n"
            "import repro_torch.launch.train\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.op_analysis\n"
            "from repro_torch.kernels.embedding_bag import BagSum\n"
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


def test_model_entry_points_default_to_the_card(tmp_path):
    """``init_params`` of both models, ``build_cell`` (serving and train
    cells) and the train CLI run on the card unless given
    ``device="cpu"``; without a card they raise."""
    from repro_torch.configs import dlrm_rm2, glm4_9b
    from repro_torch.launch import train
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import dlrm, transformer
    calls = [lambda: transformer.init_params(glm4_9b.smoke_config()),
             lambda: dlrm.init_params(dlrm_rm2.smoke_config()),
             lambda: build_cell("dlrm-rm2", "serve_p99", smoke=True),
             lambda: build_cell("glm4-9b", "train_4k", smoke=True),
             lambda: build_cell("dlrm-rm2", "train_batch", smoke=True),
             lambda: train.main(["--arch", "dlrm-rm2", "--smoke", "--steps",
                                 "1", "--ckpt-dir", str(tmp_path)])]
    if torch.cuda.is_available():
        p = calls[0]()
        assert p["embed"].device.type == "cuda"
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    p = transformer.init_params(glm4_9b.smoke_config(), device="cpu")
    assert p["layers"][0]["wq"].device.type == "cpu"


def test_store_engine_defaults_to_the_card(tmp_path):
    """The store-backed engine and server run on the card unless told
    ``device="cpu"``; without a card they raise, and leave no segment
    file open."""
    from repro_torch.launch.serve import QueryServer
    from repro_torch.storage import IndexStore, StreamingQueryEngine
    g = T.grid_road_graph(8, seed=2)
    res = T.build_hod_fast(g, T.BuildConfig(max_core_nodes=16,
                                            max_core_edges=1024))
    ix = T.pack_index(g, res, chunk=64, device="cpu")
    path = str(tmp_path / "store")
    ix.save_store(path, block_bytes=1024)
    if torch.cuda.is_available():
        eng = StreamingQueryEngine(IndexStore(path))
        assert eng.device.type == "cuda"
        eng.close()
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingQueryEngine(IndexStore(path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        QueryServer(store_path=path)
    server = QueryServer(store_path=path, engine_opts={"device": "cpu"})
    try:
        np.testing.assert_array_equal(
            server.engine.ssd(np.array([0, 63])),
            T.dijkstra_reference(g, [0, 63]))
    finally:
        server.close()
