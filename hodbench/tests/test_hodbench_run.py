"""Runs of the harness through the port's plain CPU paths, at a test's
size: the result line's keys, the data-driven look-up, the faults that
must turn ``correct`` false, and the import rules.  The harness's look
for a card is skipped by calling ``run_cell`` with ``device="cpu"``."""
import ast
import io
import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from hodbench import spec
from hodbench.reference import shortest_distances
from hodbench.run import run_cell
from hodbench.tests.support import ROOT, small_cell

import repro_torch.core.graph as port_graph
from repro_torch.core.query import QueryEngine

KEYS = ["correct", "attempted", "failed", "metrics", "device"]
SECONDS = 0.5


def _run(cell_name, trace=False, seed=2 ** 31 + 3, root=ROOT, bench=None):
    bench, cell = small_cell(cell_name, root, bench)
    return cell, run_cell(root, bench, cell, seed, SECONDS, trace,
                          device="cpu", log=io.StringIO())


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell_name", ["road-ssd", "web-sssp"])
def test_rehearsal_line_has_the_contracts_keys(cell_name, trace):
    cell, out = _run(cell_name, trace)
    line = json.loads(json.dumps(out))
    assert list(line) == KEYS + ["checks"]      # no trace, no breakdown
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert line["device"]["platform"] == "cpu"
    assert line["device"]["memory_peak_bytes"] is None
    wanted = cell.per_layer if trace else cell.end_to_end
    host = {m["name"] for m in wanted if m["source"] != "device_trace"}
    assert set(line["metrics"]) <= host         # no device metric on a CPU
    if trace:
        assert {"build_s", "pack_s", "p95_ms"} <= set(line["metrics"])
    else:
        assert set(line["metrics"]) == host == {"qps", "setup_s"}
    checks = line["checks"]
    assert checks["rows_checked"]["value"] == \
        min(cell.traffic["checked_rows"], line["attempted"])
    assert ("bad_pred" in checks) == (cell.traffic["mode"] == "sssp")


def _fault_unchanged(monkeypatch):
    """A step that returns its state unchanged: no sweep, no core search."""
    monkeypatch.setattr(QueryEngine, "_relax_sweep",
                        staticmethod(lambda dist, sweep, d=None: dist))
    monkeypatch.setattr(QueryEngine, "_core_search", lambda self, d: d)


def _fault_half(monkeypatch):
    """Half of the batch left out: its rows are the other half's."""
    ssd, sssp = QueryEngine.ssd, QueryEngine.sssp

    def half(rows):
        rows = rows.copy()
        k = rows.shape[0] // 2
        rows[k:2 * k] = rows[:k]
        return rows
    monkeypatch.setattr(QueryEngine, "ssd",
                        lambda self, s: half(ssd(self, s)))
    monkeypatch.setattr(QueryEngine, "sssp", lambda self, s: tuple(
        half(x) for x in sssp(self, s)))


def _fault_altered(monkeypatch):
    """An answer altered where it is produced: one distance a batch."""
    ssd, sssp = QueryEngine.ssd, QueryEngine.sssp

    def alter(d):
        d = d.copy()
        j = int(np.flatnonzero(np.isfinite(d[0]) & (d[0] > 0))[0])
        d[0, j] += 1.0
        return d
    monkeypatch.setattr(QueryEngine, "ssd",
                        lambda self, s: alter(ssd(self, s)))
    monkeypatch.setattr(QueryEngine, "sssp", lambda self, s: (
        lambda d, p: (alter(d), p))(*sssp(self, s)))


def _fault_pred(monkeypatch):
    """A predecessor altered where it is produced: one a batch."""
    sssp = QueryEngine.sssp

    def alter(d, p):
        p = p.copy()
        j = int(np.flatnonzero(p[0] >= 0)[0])
        p[0, j] = (p[0, j] + 1) % p.shape[1]
        return d, p
    monkeypatch.setattr(QueryEngine, "sssp", lambda self, s: alter(
        *sssp(self, s)))


def _control_in_engine(monkeypatch):
    """The precision control in the program's place: every distance row
    the engine answers is the reference's relaxation in bfloat16 over the
    arcs the run handed the port (SSSP keeps the engine's predecessors)."""
    arcs = {}
    from_edges = port_graph.from_edges

    def keep(n, src, dst, w):
        arcs.update(n=n, src=src, dst=dst, w=w)
        return from_edges(n, src, dst, w)

    def low(sources):
        return shortest_distances(
            arcs["n"], arcs["src"], arcs["dst"], arcs["w"],
            np.asarray(sources), dtype=torch.bfloat16).astype(np.float32)
    sssp = QueryEngine.sssp
    monkeypatch.setattr(port_graph, "from_edges", keep)
    monkeypatch.setattr(QueryEngine, "ssd", lambda self, s: low(s))
    monkeypatch.setattr(QueryEngine, "sssp",
                        lambda self, s: (low(s), sssp(self, s)[1]))


FAULTS = {"unchanged": (_fault_unchanged, "wrong_dist"),
          "bf16_control": (_control_in_engine, "wrong_dist"),
          "half": (_fault_half, "wrong_dist"),
          "altered": (_fault_altered, "wrong_dist"),
          "pred": (_fault_pred, "bad_pred")}


@pytest.mark.parametrize("cell_name,fault", [
    (c, f) for c in ("road-ssd", "web-sssp") for f in sorted(FAULTS)
    if f != "pred" or c == "web-sssp"])      # SSSP answers predecessors
def test_fault_turns_correct_false(cell_name, fault, monkeypatch):
    plant, caught_by = FAULTS[fault]
    plant(monkeypatch)
    _, out = _run(cell_name)
    assert out["correct"] is False
    c = out["checks"][caught_by]
    assert c["value"] > c["limit"]


def test_cell_added_as_files_alone(tmp_path):
    """A configuration, a mix and a metric added as files and entries in a
    copy of the benchmark, with no file that is there edited."""
    shutil.copytree(ROOT / "hodbench", tmp_path / "hodbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (tmp_path / "hodbench").rglob("*")
              if p.is_file()}
    bench = spec.load(ROOT)
    (tmp_path / "hodbench" / "configs" / "tiny-grid.json").write_text(
        json.dumps(dict(json.loads((ROOT / "hodbench" / "configs" /
                                    "road-grid-40k.json").read_text()),
                        name="tiny-grid",
                        graph={"kind": "grid_road", "side": 7,
                               "weight_min": 1, "weight_max": 10000},
                        pack={"chunk": 64, "k_cap": 16,
                              "closure_limit": 16384})))
    (tmp_path / "hodbench" / "traffic" / "ssd-closed8.json").write_text(
        json.dumps({"mode": "ssd", "loop": "closed", "clients": 8,
                    "sources": {"dist": "uniform"},
                    "warmup_seconds": 0.2, "checked_rows": 32}))
    (tmp_path / "hodbench" / "metrics" / "answered_in_window.py").write_text(
        "def read(ctx):\n    return ctx.answered\n")
    bench["configs"].append({"name": "tiny-grid", "source": "a test",
                             "file": "hodbench/configs/tiny-grid.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.closed8", "config": "tiny-grid",
                               "traffic": "ssd-closed8", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "answered_in_window", "unit": "q",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "front end", "moves": "qps",
                               "workloads": ["tiny.closed8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    bench = spec.load(tmp_path)
    cell = spec.cell(tmp_path, bench, "tiny.closed8")
    assert [m["name"] for m in cell.per_layer][-1] == "answered_in_window"
    for old in ("road-ssd", "web-sssp"):
        spec.cell(tmp_path, bench, old)
    out = run_cell(tmp_path, bench, cell, 5, SECONDS, True, device="cpu",
                   log=io.StringIO())
    assert out["correct"] is True
    assert out["metrics"]["answered_in_window"]["value"] > 0
    assert out["metrics"]["answered_in_window"]["unit"] == "q"
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_a_readers_fault_fails_the_run(tmp_path):
    """A metric reader that raises ends the run: its metric is not left
    out of the line in silence."""
    shutil.copytree(ROOT / "hodbench", tmp_path / "hodbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "hodbench" / "metrics" / "broken.py").write_text(
        "def read(ctx):\n    return ctx.no_such_field\n")
    bench = spec.load(ROOT)
    bench["per_layer"].append({"name": "broken", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "front end", "moves": "qps"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    bench, cell = small_cell("road-ssd", tmp_path)
    with pytest.raises(AttributeError, match="no_such_field"):
        run_cell(tmp_path, bench, cell, 6, SECONDS, True, device="cpu",
                 log=io.StringIO())


FILES = sorted(p for p in (ROOT / "hodbench").rglob("*.py")
               if "__pycache__" not in p.parts)
REFERENCE = ("reference.py", "verdict.py", "yardstick.py")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_imports(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}
    if path.name in REFERENCE:
        assert "repro_torch" not in tops


def test_a_run_loads_no_jax():
    code = ("import io, sys\n"
            f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
            "from hodbench.tests.support import ROOT, small_cell\n"
            "from hodbench.run import run_cell, forbidden_modules\n"
            "bench, cell = small_cell('web-sssp')\n"
            f"out = run_cell(ROOT, bench, cell, 1, {SECONDS}, True, "
            "device='cpu', log=io.StringIO())\n"
            "assert out['correct'], out\n"
            "print(forbidden_modules())\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the run would run")
    res = subprocess.run([sys.executable, "hodbench/run.py", "--workload",
                          "road-ssd", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert res.returncode == 2 and res.stdout == ""


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of the first cell on the card, end to end."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    res = subprocess.run([sys.executable, "hodbench/run.py", "--workload",
                          "road-ssd", "--seed", "2147483999", "--seconds",
                          "2"], capture_output=True, text=True, timeout=900,
                         cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.splitlines()[-1])["correct"] is True
