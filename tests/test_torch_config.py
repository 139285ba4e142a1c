"""The port's config spine against the JAX package's.

``repro_torch.config`` is a copy of ``repro.config`` (the port imports
nothing of the JAX package): every checked-in config must resolve to
the same ``Config.data`` in both, with PyYAML and with the built-in
subset parser; the include, precedence and cycle cases, the validation
messages, the CLI override layer and ``mixed_request_stream`` must
agree too.
"""
import argparse
import glob
import os
import sys

import numpy as np
import pytest

import repro.config as JC
import repro.launch.serve as JS
import repro_torch.config as TC
import repro_torch.launch.serve as TS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))


def _no_pyyaml(monkeypatch):
    """Make ``import yaml`` fail, so both packages use their subset
    parser."""
    monkeypatch.setitem(sys.modules, "yaml", None)


# ------------------------------------------------------- checked-in files
@pytest.mark.parametrize("parser", ["pyyaml", "subset"])
@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_checked_in_configs_resolve_alike(path, parser, monkeypatch):
    if parser == "pyyaml":
        pytest.importorskip("yaml")
    else:
        _no_pyyaml(monkeypatch)
    for defaults in (None, "serve"):
        dj = JC.SERVE_DEFAULTS if defaults else None
        dt = TC.SERVE_DEFAULTS if defaults else None
        cj, ct = JC.Config(path, defaults=dj), TC.Config(path, defaults=dt)
        assert ct.data == cj.data
        assert ct.includes == cj.includes
        assert ct.flat() == cj.flat()


def test_subset_parser_reads_the_configs_as_pyyaml_does(monkeypatch):
    pytest.importorskip("yaml")
    full = {p: TC.Config(p).data for p in CONFIGS}
    _no_pyyaml(monkeypatch)
    for p in CONFIGS:
        assert TC.Config(p).data == full[p], p


def test_serve_defaults_and_mixed_config_validate():
    assert TC.SERVE_DEFAULTS == JC.SERVE_DEFAULTS
    cfg = TC.Config(os.path.join(REPO, "configs", "serve_mixed.yaml"),
                    defaults=TC.SERVE_DEFAULTS)
    assert TC.validate_serve(cfg) is cfg
    assert cfg.get("serve.slo.p2p.batch") == 8
    assert cfg.get("serve.mix") == {"ssd": 1, "p2p": 3}


# ------------------------------------------------------- the YAML subset
@pytest.mark.parametrize("text", [
    "a: 1            # int\nb: -2.5\nc: 1e3\nd: true\ne: null\n"
    "f: 'quoted # not a comment'\ng: .inf\nh: plain string\n",
    "serve:\n  slo:\n    p2p:\n      deadline_ms: 60.0\n      batch: 8\n"
    "grid:\n  - [0.05, 2q]\n  - [1.0, lru]\ndepths: [1, 2, 4]\n"
    "jobs:\n  - name: a\n    n: 1\n  - name: b\n    n: 2\n",
    "a: &anchor 1\n", "a: {b: 1}\n", "a: 1\na: 2\n", "a:\n\tb: 1\n",
    "- just\n- a list\n",
])
def test_yaml_subset_parses_and_rejects_alike(text):
    def run(mod):
        try:
            return ("ok", mod._parse_yaml_subset(text))
        except mod.ConfigError as exc:
            return ("error", str(exc))
    assert run(TC) == run(JC)


# ------------------------------------------------- include chain cases
def _tree(tmp_path, files):
    for name, text in files.items():
        p = tmp_path / name
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)


def _load(mod, path, **kw):
    try:
        cfg = mod.Config(str(path), **kw)
        return ("ok", cfg.data, [os.path.basename(i) for i in cfg.includes])
    except mod.ConfigError as exc:
        return ("error", type(exc).__name__,
                "circular" in str(exc), "cannot read" in str(exc))


@pytest.mark.parametrize("files, top, kw", [
    ({"base.yaml": "serve:\n  batch: 4\n  rate: 1.0\n",
      "child.yaml": "_include: base.yaml\nserve:\n  batch: 8\n"},
     "child.yaml",
     dict(defaults={"serve": {"batch": 1, "rate": 0.0, "keep": 7}},
          overrides={"serve": {"rate": 9.0}})),
    ({"base.yaml": "a: 1\n",
      "sub/inner.yaml": "_include: ../base.yaml\nb: 2\n"},
     "sub/inner.yaml", {}),
    ({"a.yaml": "_include: b.yaml\n", "b.yaml": "_include: a.yaml\n"},
     "a.yaml", {}),
    ({"c.yaml": "_include: nope.yaml\n"}, "c.yaml", {}),
    ({"l1.yaml": "x: 1\n",
      "l2.yaml": "_include: [l1.yaml]\ny: [1, 2]\n",
      "l3.yaml": "_include: l2.yaml\ny: [3]\n"}, "l3.yaml", {}),
], ids=["precedence", "relative", "cycle", "missing", "list-replaces"])
def test_include_chain_alike(tmp_path, files, top, kw):
    _tree(tmp_path, files)
    got, want = _load(TC, tmp_path / top, **kw), _load(JC, tmp_path / top,
                                                        **kw)
    assert got == want
    if top == "child.yaml":
        assert got[1]["serve"] == {"batch": 8, "rate": 9.0, "keep": 7}
    if top == "a.yaml":
        assert got[2]      # a cycle is named as one
    if top == "c.yaml":
        assert got[3]


def test_accessors_and_deep_update():
    d = {"serve": {"slo": {"p2p": {"deadline_ms": 60.0}}}}
    cfg = TC.Config(None, defaults=d)
    assert cfg.get("serve.slo.p2p.deadline_ms") == 60.0
    assert cfg.get("serve.slo.knn.deadline_ms", 5.0) == 5.0
    with pytest.raises(TC.ConfigError, match="serve.missing"):
        cfg.require("serve.missing")
    assert cfg.sub("serve.slo").get("p2p.deadline_ms") == 60.0
    assert cfg.flat() == JC.Config(None, defaults=d).flat()
    base = {"a": {"l": [1, 2, 3], "keep": 1}, "top": 0}
    assert TC.deep_update(dict(base), {"a": {"l": [9]}}) \
        == JC.deep_update(dict(base), {"a": {"l": [9]}})


# ------------------------------------------------- parse-time validation
@pytest.mark.parametrize("overrides, key", [
    ({"store": {"cache_frac": 0.0}}, "store.cache_frac"),
    ({"store": {"cache_frac": 1.5}}, "store.cache_frac"),
    ({"store": {"pin_frac": -0.1}}, "store.pin_frac"),
    ({"serve": {"max_wait_ms": -1.0}}, "serve.max_wait_ms"),
    ({"serve": {"batch": 0}}, "serve.batch"),
    ({"serve": {"cache_entries": -1}}, "serve.cache_entries"),
    ({"store": {"queue_depth": 0}}, "store.queue_depth"),
    ({"store": {"decode_workers": 0}}, "store.decode_workers"),
    ({"store": {"cache_policy": "fifo"}}, "store.cache_policy"),
    ({"store": {"codec": "zip"}}, "store.codec"),
    ({"serve": {"scheduler": "lifo"}}, "serve.scheduler"),
    ({"serve": {"mode": "kn"}}, "serve.mode"),
    ({"serve": {"mode": "top_k"}}, "serve.mode"),
    ({"serve": {"rate": -1.0}}, "serve.rate"),
    ({"serve": {"threshold": 0.0}}, "serve.threshold"),
    ({"serve": {"k": 0}}, "serve.k"),
    ({"serve": {"slo": {"ssd": {"deadline_ms": -1.0}}}},
     "serve.slo.ssd.deadline_ms"),
    ({"serve": {"slo": {"ssd": {}}}}, "serve.slo.ssd.deadline_ms"),
    ({"serve": {"slo": {"ssd": {"deadline_ms": 5.0, "batch": 0}}}},
     "serve.slo.ssd.batch"),
    ({"serve": {"mix": {"ssd": 0.0}}}, "serve.mix.ssd"),
])
def test_validate_serve_names_the_same_key(overrides, key):
    msgs = []
    for mod in (TC, JC):
        cfg = mod.Config(None, defaults=mod.SERVE_DEFAULTS,
                         overrides=overrides)
        with pytest.raises(mod.ConfigError,
                           match=key.replace(".", r"\.")) as exc:
            mod.validate_serve(cfg)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


# ----------------------------------------------------------- CLI layering
def test_overrides_from_args_only_typed_flags():
    ns = argparse.Namespace(batch=7, cache_frac=0.5, trace_out="t.json")
    got = TC.overrides_from_args(ns, TS._CLI_SPEC)
    assert got == JC.overrides_from_args(ns, JS._CLI_SPEC)
    assert got == {"serve": {"batch": 7}, "store": {"cache_frac": 0.5},
                   "obs": {"trace_out": "t.json"}}
    assert TS._CLI_SPEC == JS._CLI_SPEC


MIXED = os.path.join(REPO, "configs", "serve_mixed.yaml")


@pytest.mark.parametrize("argv", [
    [], ["--batch", "5", "--scheduler", "slo"],
    ["--config", MIXED], ["--config", MIXED, "--batch", "9",
                          "--max-wait-ms", "7"],
    ["--no-prefetch"], ["--mode", "topk", "--k", "3"],
    ["--mode", "threshold", "--threshold", "4.5"],
    ["--store", "--codec", "delta", "--cache-frac", "0.05",
     "--cache-policy", "arc", "--queue-depth", "2", "--pin-frac", "0.3"],
    ["--trace-out", "x.json", "--metrics-out", "m.json", "--rate", "50"],
    ["--graph", "web", "--side", "7", "--requests", "11", "--cache", "0"],
    ["--shards", "2"], ["--use-pallas"],
])
def test_load_serve_config_gives_the_same_dict(argv):
    got = TS.load_serve_config(TS.build_arg_parser().parse_args(argv))
    want = JS.load_serve_config(JS.build_arg_parser().parse_args(argv))
    assert got.data == want.data
    assert got.path == want.path


@pytest.mark.parametrize("argv", [
    ["--cache-frac", "1.5"], ["--cache-frac", "0"],
    ["--pin-frac", "1.1"], ["--pin-frac", "-0.1"],
    ["--max-wait-ms", "-1"], ["--batch", "0"],
    ["--threshold", "0"], ["--k", "0"], ["--queue-depth", "0"],
])
def test_cli_rejects_bad_values_at_parse_time(argv):
    for mod in (TS, JS):
        with pytest.raises(SystemExit):
            mod.build_arg_parser().parse_args(argv)


def test_cli_device_flags_stay_outside_the_config():
    args = TS.build_arg_parser().parse_args(
        ["--device", "cpu", "--closure-limit", "64", "--batch", "3"])
    cfg = TS.load_serve_config(args)
    assert (args.device, args.closure_limit) == ("cpu", 64)
    assert cfg.get("serve.batch") == 3
    assert "device" not in cfg.flat() and "closure_limit" not in cfg.flat()


# ------------------------------------------------------ mixed-stream helper
@pytest.mark.parametrize("mix, n, count, seed, pool", [
    ({"ssd": 1, "p2p": 3}, 100, 200, 3, 4),
    ({"ssd": 1, "p2p": 3}, 40000, 400, 0, 16),
    ({"ssd": 2, "within": 1, "knn": 1}, 50, 64, 7, 16),
    (None, 30, 20, 1, 16),
])
def test_mixed_request_stream_alike(mix, n, count, seed, pool):
    over = {"serve": {"mix": mix}} if mix else None
    got = TS.mixed_request_stream(
        TC.Config(None, defaults=TC.SERVE_DEFAULTS, overrides=over), n,
        count, np.random.default_rng(seed), p2p_pool=pool)
    want = JS.mixed_request_stream(
        JC.Config(None, defaults=JC.SERVE_DEFAULTS, overrides=over), n,
        count, np.random.default_rng(seed), p2p_pool=pool)
    assert got == want
    assert len(got) == count


def test_mixed_request_stream_tiny_graph_alike():
    over = {"serve": {"mix": {"p2p": 1}}}
    for seed in range(20):
        got = TS.mixed_request_stream(
            TC.Config(None, defaults=TC.SERVE_DEFAULTS, overrides=over), 2,
            8, np.random.default_rng(seed), p2p_pool=2)
        want = JS.mixed_request_stream(
            JC.Config(None, defaults=JC.SERVE_DEFAULTS, overrides=over), 2,
            8, np.random.default_rng(seed), p2p_pool=2)
        assert got == want
        assert len(got) == 8 and all(m == "p2p" and s != t
                                     for m, (s, t) in got)
