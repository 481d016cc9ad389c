"""Partitioner spec strings: parse, format, fingerprint, run.

One string selects any registered partitioner with its config:

    spec   := method [ "(" args ")" ] [ "+f" [ "(" args ")" ] ]
    method := [A-Za-z_][A-Za-z0-9_-]*        (normalized: lower, "-" -> "_")
    args   := [ name "=" value {"," name "=" value} ]
    value  := int | float | true | false | none | 'string' | bareword

Examples: ``"metis"``, ``"lpa(max_iter=30,balance_cap=1.5)"``,
``"metis+f(alpha=0.1)"``, ``"leiden_fusion(resolution=0.5)"``. ``+f`` is
the paper's §5.4 fusion operator over any registered base method.

``PartitionerSpec.canonical()`` prints only the non-default fields, in
declaration order, so ``"lpa(max_iter=50)"`` canonicalizes to ``"lpa"``.
``fingerprint()`` hashes the method name and the fully resolved config
(defaults included). Both are the reference package's to the byte: the
artifact cache and the serving bundle key on them, and bundles are shared
between the packages.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import re
import time
import types
import typing
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np

from .fusion import fuse
from .graph import Graph
from .registry import FusionConfig, get_entry, registered_partitioners

__all__ = ["PartitionResult", "PartitionerSpec", "partition_from_spec",
           "parse_spec_text", "build_config", "format_value"]


# -- grammar: text -> (method, args, fusion_args | None) ---------------------

_NAME = r"[A-Za-z_][A-Za-z0-9_-]*"
# an args blob is anything paren-free, except that quoted string values may
# hold parens (so canonical() output always parses again)
_ARGS = r"(?:[^()'\"]|'[^']*'|\"[^\"]*\")*?"
_SPEC_RE = re.compile(
    rf"^\s*(?P<method>{_NAME})\s*(?:\(\s*(?P<args>{_ARGS})\s*\))?"
    rf"\s*(?P<fusion>\+\s*[fF]\s*(?:\(\s*(?P<fargs>{_ARGS})\s*\))?)?\s*$")
_BARE_RE = re.compile(rf"^{_NAME}$")


def _parse_value(token: str, spec: str) -> Any:
    t = token.strip()
    low = t.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("none", "null"):
        return None
    try:
        return int(t)
    except ValueError:
        pass
    try:
        return float(t)
    except ValueError:
        pass
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "'\"":
        return t[1:-1]
    if _BARE_RE.match(t):
        return t
    raise ValueError(f"bad spec {spec!r}: cannot parse value {token!r}")


def _split_args(blob: str) -> list:
    """Split on commas, but not inside quoted string values."""
    parts, buf, quote = [], [], None
    for ch in blob:
        if quote:
            buf.append(ch)
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
            buf.append(ch)
        elif ch == ",":
            parts.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
    parts.append("".join(buf))
    return parts


def _parse_args(blob: Optional[str], spec: str) -> Optional[Dict[str, Any]]:
    if blob is None:
        return None
    args: Dict[str, Any] = {}
    blob = blob.strip()
    if not blob:
        return args
    for part in _split_args(blob):
        if "=" not in part:
            raise ValueError(f"bad spec {spec!r}: expected name=value, "
                             f"got {part.strip()!r}")
        name, value = part.split("=", 1)
        name = name.strip().lower()
        if not _BARE_RE.match(name):
            raise ValueError(f"bad spec {spec!r}: bad field name {name!r}")
        if name in args:
            raise ValueError(f"bad spec {spec!r}: duplicate field {name!r}")
        args[name] = _parse_value(value, spec)
    return args


def parse_spec_text(text: str) -> Tuple[str, Dict[str, Any],
                                        Optional[Dict[str, Any]]]:
    """Syntactic parse only (no registry lookup): ``(method, args,
    fusion_args)``, with ``fusion_args`` None without ``+f`` and ``{}`` for
    a bare ``+f``."""
    m = _SPEC_RE.match(text or "")
    if not m:
        raise ValueError(
            f"bad partitioner spec {text!r}; expected "
            f"\"method\", \"method(field=value,...)\", or \"method+f(...)\"")
    method = m.group("method").lower().replace("-", "_")
    args = _parse_args(m.group("args"), text) or {}
    fargs = None
    if m.group("fusion") is not None:
        fargs = _parse_args(m.group("fargs") or "", text)
    return method, args, fargs


# -- typed config construction -----------------------------------------------

def _coerce(value: Any, annot: Any, field: str, where: str) -> Any:
    origin = typing.get_origin(annot)
    # typing.Optional/Union and PEP 604 `T | None` (types.UnionType)
    if origin is Union or origin is getattr(types, "UnionType", None):
        members = typing.get_args(annot)
        if value is None and type(None) in members:
            return None
        for member in members:
            if member is type(None):
                continue
            try:
                return _coerce(value, member, field, where)
            except (TypeError, ValueError):
                pass
        raise TypeError(f"{where}: field {field!r} expects {annot}, "
                        f"got {value!r}")
    if annot is bool:
        if isinstance(value, bool):
            return value
    elif annot is int:
        if isinstance(value, bool):
            pass
        elif isinstance(value, int):
            return value
        elif isinstance(value, float) and value.is_integer():
            return int(value)
    elif annot is float:
        if isinstance(value, bool):
            pass
        elif isinstance(value, (int, float)):
            v = float(value)
            if not math.isfinite(v):
                raise ValueError(f"{where}: field {field!r} must be finite, "
                                 f"got {value!r}")
            return v
    elif annot is str:
        if isinstance(value, str):
            return value
    else:
        return value                        # unconstrained annotation
    raise TypeError(f"{where}: field {field!r} expects "
                    f"{getattr(annot, '__name__', annot)}, got {value!r}")


def build_config(config_type: type, args: Dict[str, Any], where: str) -> Any:
    """Instantiate a frozen config dataclass from parsed spec args, with
    field-name checks and int/float coercion."""
    hints = typing.get_type_hints(config_type)
    fields = {f.name: f for f in dataclasses.fields(config_type)}
    kwargs = {}
    for name, value in args.items():
        if name not in fields:
            raise ValueError(
                f"unknown field {name!r} for partitioner {where!r}; "
                f"expected: {', '.join(fields) or '(no fields)'}")
        kwargs[name] = _coerce(value, hints.get(name, Any), name, where)
    return config_type(**kwargs)


def format_value(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "none"
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, str):
        # barewords stay unquoted unless they would parse as a keyword;
        # anything else (commas, '=', spaces, digits) is quoted
        if _BARE_RE.match(v) and v.lower() not in ("true", "false", "none",
                                                   "null"):
            return v
        q = '"' if "'" in v else "'"
        return f"{q}{v}{q}"
    return str(v)


def _format_args(config: Any) -> str:
    parts = []
    for f in dataclasses.fields(config):
        v = getattr(config, f.name)
        default = f.default if f.default is not dataclasses.MISSING else \
            (f.default_factory() if f.default_factory is not dataclasses.MISSING
             else dataclasses.MISSING)
        if v != default:
            parts.append(f"{f.name}={format_value(v)}")
    return f"({','.join(parts)})" if parts else ""


# -- the typed spec and its result -------------------------------------------

@dataclasses.dataclass(frozen=True)
class PartitionResult:
    """One partitioner run: labels, the canonical spec, the config
    fingerprint (the artifact cache's key component), and provenance."""
    labels: np.ndarray
    spec: str                       # canonical spec string
    fingerprint: str                # hash of method + full resolved config
    k: int
    seed: int
    seconds: float
    provenance: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class PartitionerSpec:
    """A fully resolved partitioner selection: method, typed config, and
    the optional ``+f`` fusion combinator."""
    method: str
    config: Any
    fusion: Optional[FusionConfig] = None

    @classmethod
    def parse(cls, text: Union[str, "PartitionerSpec"]) -> "PartitionerSpec":
        if isinstance(text, PartitionerSpec):
            return text
        method, args, fargs = parse_spec_text(text)
        names = registered_partitioners()
        if method not in names and method.endswith("_f") \
                and method[:-2] in names:
            # legacy alias: "metis_f" == "metis+f" (bare form only)
            if args or fargs is not None:
                raise ValueError(
                    f"bad spec {text!r}: the legacy {method!r} alias takes "
                    f"no arguments — use \"{method[:-2]}+f(...)\"")
            method, fargs = method[:-2], {}
        entry = get_entry(method)           # ValueError on unknown method
        config = build_config(entry.config_type, args, method)
        fusion = None
        if fargs is not None:
            fusion = build_config(FusionConfig, fargs, f"{method}+f")
        return cls(method=entry.name, config=config, fusion=fusion)

    def canonical(self) -> str:
        s = self.method + _format_args(self.config)
        if self.fusion is not None:
            s += "+f" + _format_args(self.fusion)
        return s

    def __str__(self) -> str:
        return self.canonical()

    def fingerprint(self) -> str:
        """16-hex-char digest of the method name and the full resolved
        config (defaults included), stable across processes."""
        payload = {"method": self.method,
                   "config": dataclasses.asdict(self.config),
                   "fusion": (dataclasses.asdict(self.fusion)
                              if self.fusion is not None else None)}
        blob = json.dumps(payload, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    @property
    def capabilities(self):
        caps = get_entry(self.method).capabilities
        if self.fusion is not None:
            # +f splits every partition into components and fuses
            # neighbours, so connectivity holds whatever the base. Balance
            # is not upgraded: fuse() caps merges only best-effort
            caps = dataclasses.replace(caps, connectivity_guaranteed=True)
        return caps

    def partition(self, g: Graph, k: int, seed: int = 0) -> PartitionResult:
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        entry = get_entry(self.method)
        provenance: Dict[str, Any] = {
            "method": self.method,
            "config": dataclasses.asdict(self.config)}
        t0 = time.time()
        if self.fusion is None:
            labels = entry.fn(g, k, seed, self.config)
        else:
            from .partitioners import split_into_components
            base_k = self.fusion.base_k or k
            t_base = time.time()
            base_labels = entry.fn(g, base_k, seed, self.config)
            provenance["base_seconds"] = round(time.time() - t_base, 4)
            t_fuse = time.time()
            comms = split_into_components(g, base_labels)
            max_part_size = (g.n / k) * (1.0 + self.fusion.alpha)
            labels = fuse(g, comms, k, max_part_size)
            provenance["fusion"] = dataclasses.asdict(self.fusion)
            provenance["base_communities"] = int(comms.max()) + 1
            provenance["fusion_seconds"] = round(time.time() - t_fuse, 4)
        labels = np.asarray(labels, dtype=np.int64)
        if labels.shape != (g.n,):
            raise ValueError(f"partitioner {self.method!r} returned labels "
                             f"of shape {labels.shape}, expected ({g.n},)")
        return PartitionResult(labels=labels, spec=self.canonical(),
                               fingerprint=self.fingerprint(), k=int(k),
                               seed=int(seed), seconds=time.time() - t0,
                               provenance=provenance)


def partition_from_spec(g: Graph, spec: Union[str, PartitionerSpec], k: int,
                        seed: int = 0) -> PartitionResult:
    """One call: ``partition_from_spec(g, "lpa+f(alpha=0.1)", 8)``."""
    return PartitionerSpec.parse(spec).partition(g, k, seed=seed)
