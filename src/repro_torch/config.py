"""Hierarchical, include-based serving configuration (DESIGN.md §12).

The JAX package's ``config.py``, copied so that the port needs nothing
of that package: the same parser, the same layering and the same
validation, so one file under ``configs/`` gives one ``Config.data`` in
both packages.  A :class:`Config` is one nested mapping loaded from a
YAML/JSON file, composed through an ``_include`` chain, with CLI flags
kept as the *last*-precedence override layer:

    defaults  <  include chain (deepest first)  <  the file itself  <
    CLI / explicit overrides

Include paths resolve relative to the including file; ``get`` takes a
dotted path.  The entry points own their argparse surfaces and pass the
explicitly typed flags in as the override layer
(:func:`overrides_from_args`).

No dependencies: ``.json`` parses with :mod:`json`; ``.yaml`` uses
PyYAML when importable, else a built-in strict *subset* parser
(indentation-nested mappings, ``- `` list items, scalars, ``#``
comments, flow lists ``[a, b]``) that covers every file under
``configs/``.  Unsupported YAML (anchors, multi-line strings, flow
maps) raises :class:`ConfigError` instead of misparsing.

Validation happens at *parse time*: :func:`validate_serve` rejects
out-of-range ``cache_frac``/``pin_frac``/``max_wait_ms``/… with a
message naming the offending key, instead of failing deep inside
``PageCache`` or asyncio.
"""
from __future__ import annotations

import copy
import json
import os
import re
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

__all__ = ["Config", "ConfigError", "deep_update", "validate_serve",
           "overrides_from_args", "SERVE_DEFAULTS"]

#: Key whose value names the file(s) this one layers on top of.
INCLUDE_KEY = "_include"


class ConfigError(ValueError):
    """A config file failed to parse, resolve, or validate."""


# ------------------------------------------------------------ YAML subset
_SCALARS = {"null": None, "~": None, "true": True, "false": False,
            "True": True, "False": False}
_NUM_RE = re.compile(r"^-?\d+$")
_FLOAT_RE = re.compile(r"^-?(\d+\.\d*|\.\d+|\d+)([eE][+-]?\d+)?$")


def _scalar(tok: str, where: str):
    tok = tok.strip()
    if tok in _SCALARS:
        return _SCALARS[tok]
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "'\"":
        return tok[1:-1]
    if _NUM_RE.match(tok):
        return int(tok)
    if _FLOAT_RE.match(tok):
        return float(tok)
    if tok in (".inf", "inf"):
        return float("inf")
    if tok.startswith("&") or tok.startswith("*") or tok.startswith("{"):
        raise ConfigError(f"{where}: unsupported YAML construct {tok!r} "
                          "(anchors/flow maps are outside the built-in "
                          "subset — install PyYAML or use JSON)")
    return tok


def _split_comment(line: str) -> str:
    """Strip a `` # comment`` suffix (quote-aware enough for our files)."""
    out, quote = [], None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            break
        out.append(ch)
    return "".join(out).rstrip()


def _parse_yaml_subset(text: str, where: str = "<yaml>") -> dict:
    """Indentation-nested mappings/lists/scalars — see module docstring."""
    lines: List[Tuple[int, str, int]] = []   # (indent, content, lineno)
    for n, raw in enumerate(text.splitlines(), 1):
        line = _split_comment(raw)
        if not line.strip():
            continue
        if line.lstrip().startswith("---"):
            continue
        indent = len(line) - len(line.lstrip(" "))
        if line[indent: indent + 1] == "\t":
            raise ConfigError(f"{where}:{n}: tabs in indentation")
        lines.append((indent, line.strip(), n))

    def parse_block(i: int, indent: int) -> Tuple[Any, int]:
        if i >= len(lines) or lines[i][0] < indent:
            return {}, i
        if lines[i][1].startswith("- "):
            return parse_list(i, lines[i][0])
        return parse_map(i, lines[i][0])

    def parse_list(i: int, indent: int) -> Tuple[list, int]:
        items: list = []
        while i < len(lines) and lines[i][0] == indent \
                and lines[i][1].startswith("- "):
            ind, content, n = lines[i]
            body = content[2:].strip()
            loc = f"{where}:{n}"
            if not body:
                child, i = parse_block(i + 1, indent + 1)
                items.append(child)
            elif ":" in body and not body.startswith(("'", '"', "[")):
                # inline "- key: value" starts a nested mapping item
                sub, i = parse_inline_map_item(i, indent)
                items.append(sub)
            else:
                items.append(_parse_flow_or_scalar(body, loc))
                i += 1
        return items, i

    def parse_inline_map_item(i: int, indent: int) -> Tuple[dict, int]:
        ind, content, n = lines[i]
        key, _, rest = content[2:].partition(":")
        item: dict = {}
        loc = f"{where}:{n}"
        if rest.strip():
            item[key.strip()] = _parse_flow_or_scalar(rest.strip(), loc)
            i += 1
        else:
            child, i = parse_block(i + 1, indent + 3)
            item[key.strip()] = child
        # subsequent keys of the same list item sit 2 deeper
        while i < len(lines) and lines[i][0] == indent + 2 \
                and not lines[i][1].startswith("- "):
            sub, i = parse_map(i, indent + 2)
            item.update(sub)
        return item, i

    def parse_map(i: int, indent: int) -> Tuple[dict, int]:
        out: Dict[str, Any] = {}
        while i < len(lines) and lines[i][0] == indent \
                and not lines[i][1].startswith("- "):
            ind, content, n = lines[i]
            loc = f"{where}:{n}"
            if ":" not in content:
                raise ConfigError(f"{loc}: expected 'key: value', got "
                                  f"{content!r}")
            key, _, rest = content.partition(":")
            key = key.strip()
            if key in out:
                raise ConfigError(f"{loc}: duplicate key {key!r}")
            if rest.strip():
                out[key] = _parse_flow_or_scalar(rest.strip(), loc)
                i += 1
            else:
                child, i = parse_block(i + 1, indent + 1)
                out[key] = child
        if i < len(lines) and lines[i][0] > indent:
            raise ConfigError(f"{where}:{lines[i][2]}: unexpected indent")
        return out, i

    def _parse_flow_or_scalar(tok: str, loc: str):
        if tok.startswith("[") and tok.endswith("]"):
            inner = tok[1:-1].strip()
            if not inner:
                return []
            return [_scalar(t, loc) for t in inner.split(",")]
        return _scalar(tok, loc)

    doc, i = parse_block(0, 0)
    if i != len(lines):
        raise ConfigError(f"{where}:{lines[i][2]}: trailing content at "
                          "top level")
    if not isinstance(doc, dict):
        raise ConfigError(f"{where}: top level must be a mapping")
    return doc


def _load_file(path: str) -> dict:
    try:
        with open(path) as f:
            text = f.read()
    except OSError as exc:
        raise ConfigError(f"cannot read config {path!r}: {exc}") from exc
    if path.endswith(".json"):
        try:
            doc = json.loads(text)
        except json.JSONDecodeError as exc:
            raise ConfigError(f"{path}: invalid JSON: {exc}") from exc
    else:
        try:
            import yaml   # type: ignore
            doc = yaml.safe_load(text)
        except ImportError:
            doc = _parse_yaml_subset(text, where=path)
        except Exception as exc:
            raise ConfigError(f"{path}: invalid YAML: {exc}") from exc
    if doc is None:
        doc = {}
    if not isinstance(doc, dict):
        raise ConfigError(f"{path}: top level must be a mapping, "
                          f"got {type(doc).__name__}")
    return doc


def deep_update(base: dict, over: dict) -> dict:
    """Recursively merge ``over`` into ``base`` (in place, returned).
    Nested dicts merge key-wise; everything else (including lists)
    replaces wholesale — a config that *narrows* a grid must be able
    to drop entries, so lists never concatenate."""
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            deep_update(base[k], v)
        else:
            base[k] = copy.deepcopy(v)
    return base


class Config:
    """One resolved, hierarchical configuration mapping.

    ``Config(path, defaults=..., overrides=...)`` loads ``path``
    (YAML/JSON), resolves its ``_include`` chain (paths relative to
    the including file; deepest include = lowest precedence; cycles
    are an error), then layers ``defaults < includes < file <
    overrides``.  ``path=None`` builds from ``defaults``/``overrides``
    alone, so programmatic callers share one code path.

    Access: ``cfg["serve"]["batch"]``, dotted ``cfg.get("serve.batch",
    32)``, ``cfg.sub("serve")`` for a nested :class:`Config` view.
    """

    def __init__(self, path: Optional[str] = None, *,
                 defaults: Optional[dict] = None,
                 overrides: Optional[dict] = None):
        data: dict = copy.deepcopy(defaults) if defaults else {}
        self.path = path
        self.includes: List[str] = []
        if path is not None:
            deep_update(data, self._resolve(path, seen=[]))
        if overrides:
            deep_update(data, overrides)
        self.data = data

    def _resolve(self, path: str, seen: List[str]) -> dict:
        apath = os.path.abspath(path)
        if apath in seen:
            chain = " -> ".join(seen + [apath])
            raise ConfigError(f"circular _include chain: {chain}")
        doc = _load_file(path)
        inc = doc.pop(INCLUDE_KEY, None)
        merged: dict = {}
        if inc is not None:
            incs = [inc] if isinstance(inc, str) else list(inc)
            for rel in incs:
                if not isinstance(rel, str):
                    raise ConfigError(f"{path}: {INCLUDE_KEY} entries "
                                      f"must be paths, got {rel!r}")
                ipath = os.path.join(os.path.dirname(apath), rel)
                deep_update(merged, self._resolve(ipath, seen + [apath]))
                self.includes.append(ipath)
        return deep_update(merged, doc)

    # --------------------------------------------------------- mapping API
    def __getitem__(self, key: str) -> Any:
        return self.data[key]

    def __contains__(self, key: str) -> bool:
        return key in self.data

    def __iter__(self) -> Iterator[str]:
        return iter(self.data)

    def __repr__(self) -> str:
        src = self.path or "<dict>"
        return f"Config({src!r}, {len(self.data)} top-level keys)"

    def get(self, dotted: str, default: Any = None) -> Any:
        """``get("serve.slo.p2p.deadline_ms", 2.0)`` — dotted descent;
        returns ``default`` at the first missing/non-mapping hop."""
        node: Any = self.data
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def require(self, dotted: str) -> Any:
        """Like :meth:`get` but a missing key is a :class:`ConfigError`
        naming the key and the source file."""
        sentinel = object()
        v = self.get(dotted, sentinel)
        if v is sentinel:
            raise ConfigError(f"missing required config key {dotted!r}"
                              f" (from {self.path or '<dict>'})")
        return v

    def sub(self, dotted: str) -> "Config":
        """Nested mapping as a new :class:`Config` view (empty if
        missing)."""
        node = self.get(dotted, {})
        if not isinstance(node, dict):
            raise ConfigError(f"config key {dotted!r} is not a mapping")
        out = Config()
        out.data = node
        out.path = self.path
        return out

    def to_dict(self) -> dict:
        return copy.deepcopy(self.data)

    def flat(self, prefix: str = "") -> Dict[str, Any]:
        """Dotted-key flattening, for logging / bench-row stamping."""
        out: Dict[str, Any] = {}

        def walk(node: Any, pfx: str) -> None:
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, f"{pfx}.{k}" if pfx else str(k))
            else:
                out[pfx] = node
        walk(self.data, prefix)
        return out


# ------------------------------------------------------- serve validation
#: Defaults the serve CLI / config spine layer under everything else —
#: the single source of truth the argparse surface also prints.
SERVE_DEFAULTS: Dict[str, Any] = {
    "graph": {"kind": "road", "side": 60},
    "serve": {
        "batch": 32, "mode": "ssd", "requests": 200, "rate": 0.0,
        "max_wait_ms": 2.0, "cache_entries": 1024,
        "threshold": 10.0, "k": 10, "use_pallas": False,
        "scheduler": "fifo",        # "fifo" | "slo"
        "slo": {},                  # class -> {deadline_ms, batch?}
        "mix": {},                  # mode -> request share (mixed traffic)
        "shards": None,             # null = unsharded; N >= 1 = fleet
    },
    "store": {
        "enabled": False, "cache_frac": 0.25, "cache_policy": "2q",
        "codec": "raw", "queue_depth": 4, "decode_workers": 2,
        "pin_frac": None, "prefetch": True,
    },
    "obs": {"trace_out": None, "metrics_out": None},
}

_POLICIES = ("lru", "clock", "arc", "2q")
_CODECS = ("raw", "delta", "f16")
_SCHEDULERS = ("fifo", "slo")
#: Accepted ``serve.mode`` spellings: the CLI aliases plus the two
#: internal names (``sssp`` = the --sssp variant of ssd; ``within`` =
#: the server-side name of ``threshold``).  A typo ("kn", "top_k")
#: dies here with the key named, never silently coerced to ssd.
_SERVE_MODES = ("ssd", "sssp", "p2p", "threshold", "within", "topk",
                "knn")


def _check(cond: bool, key: str, got: Any, want: str) -> None:
    if not cond:
        raise ConfigError(f"config key {key!r} = {got!r}: must be {want}")


def validate_serve(cfg: Config) -> Config:
    """Parse-time validation of a serve config:
    every budget fraction, wait, and size is range-checked here with a
    message naming the key — *before* a ``PageCache`` or the asyncio
    scheduler can fail obscurely at depth.  Returns ``cfg``."""
    frac = cfg.get("store.cache_frac")
    _check(isinstance(frac, (int, float)) and 0.0 < float(frac) <= 1.0,
           "store.cache_frac", frac, "a fraction in (0, 1]")
    pin = cfg.get("store.pin_frac")
    _check(pin is None or (isinstance(pin, (int, float))
                           and 0.0 <= float(pin) <= 1.0),
           "store.pin_frac", pin, "null or a fraction in [0, 1]")
    wait = cfg.get("serve.max_wait_ms")
    _check(isinstance(wait, (int, float)) and float(wait) >= 0.0,
           "serve.max_wait_ms", wait, "a non-negative number of ms")
    batch = cfg.get("serve.batch")
    _check(isinstance(batch, int) and batch >= 1,
           "serve.batch", batch, "an integer >= 1")
    entries = cfg.get("serve.cache_entries")
    _check(isinstance(entries, int) and entries >= 0,
           "serve.cache_entries", entries, "an integer >= 0")
    depth = cfg.get("store.queue_depth")
    _check(isinstance(depth, int) and depth >= 1,
           "store.queue_depth", depth, "an integer >= 1")
    workers = cfg.get("store.decode_workers")
    _check(isinstance(workers, int) and workers >= 1,
           "store.decode_workers", workers, "an integer >= 1")
    policy = cfg.get("store.cache_policy")
    _check(policy in _POLICIES, "store.cache_policy", policy,
           f"one of {_POLICIES}")
    codec = cfg.get("store.codec")
    _check(codec in _CODECS, "store.codec", codec, f"one of {_CODECS}")
    sched = cfg.get("serve.scheduler")
    _check(sched in _SCHEDULERS, "serve.scheduler", sched,
           f"one of {_SCHEDULERS}")
    mode = cfg.get("serve.mode")
    _check(mode in _SERVE_MODES, "serve.mode", mode,
           f"one of {_SERVE_MODES}")
    rate = cfg.get("serve.rate")
    _check(isinstance(rate, (int, float)) and float(rate) >= 0.0,
           "serve.rate", rate, "a non-negative req/s rate")
    thr = cfg.get("serve.threshold")
    _check(isinstance(thr, (int, float)) and float(thr) > 0.0,
           "serve.threshold", thr, "a positive distance")
    k = cfg.get("serve.k")
    _check(isinstance(k, int) and k >= 1, "serve.k", k,
           "an integer >= 1")
    shards = cfg.get("serve.shards")
    _check(shards is None or (isinstance(shards, int) and shards >= 1),
           "serve.shards", shards, "null or an integer >= 1 "
           "(serving-fleet shard count)")
    slo = cfg.get("serve.slo", {})
    _check(isinstance(slo, dict), "serve.slo", slo,
           "a {class: {deadline_ms: ...}} mapping")
    for name, spec in slo.items():
        _check(isinstance(spec, dict), f"serve.slo.{name}", spec,
               "a mapping with deadline_ms")
        dl = spec.get("deadline_ms")
        _check(isinstance(dl, (int, float)) and float(dl) > 0.0,
               f"serve.slo.{name}.deadline_ms", dl, "a positive ms "
               "deadline")
        cb = spec.get("batch")
        _check(cb is None or (isinstance(cb, int) and cb >= 1),
               f"serve.slo.{name}.batch", cb, "null or an integer >= 1")
    mix = cfg.get("serve.mix", {})
    _check(isinstance(mix, dict), "serve.mix", mix,
           "a {mode: share} mapping")
    for name, share in mix.items():
        _check(isinstance(share, (int, float)) and float(share) > 0.0,
               f"serve.mix.{name}", share, "a positive share")
    return cfg


def overrides_from_args(args, spec: Sequence[Tuple[str, str]]) -> dict:
    """Build the CLI-override layer from an ``argparse.Namespace``
    parsed with ``argparse.SUPPRESS`` defaults: only flags the user
    actually typed exist as attributes, so only those override the
    config file.  ``spec`` maps attribute -> dotted config key."""
    out: dict = {}
    for attr, dotted in spec:
        if not hasattr(args, attr):
            continue
        node = out
        *parents, leaf = dotted.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = getattr(args, attr)
    return out
