"""The partitioner registry: named, typed, capability-tagged methods.

A partitioner maps ``(Graph, k, seed, config) -> labels``. Registering one
with :func:`register_partitioner` makes it selectable wherever a spec
string is accepted (``PipelineConfig.method``, the CLI's ``--method``, the
artifact cache). :class:`FusionConfig` configures the ``+f`` combinator
(paper §5.4), which composes over any registered method; see
:mod:`repro_torch.core.spec`.

The names, config fields and defaults are the reference package's, so a
spec string fingerprints alike in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Type

import numpy as np

from .graph import Graph

__all__ = ["Capabilities", "FusionConfig", "NullConfig",
           "RegisteredPartitioner", "register_partitioner",
           "unregister_partitioner", "registered_partitioners", "get_entry"]


@dataclasses.dataclass(frozen=True)
class Capabilities:
    """What a partitioner guarantees about its output on a connected
    graph."""
    connectivity_guaranteed: bool = False   # every partition is 1 component
    balanced: bool = False                  # sizes bounded by a slack factor
    deterministic: bool = True              # same (g, k, seed, cfg) -> same labels

    def describe(self) -> str:
        flags = [("connectivity", self.connectivity_guaranteed),
                 ("balanced", self.balanced),
                 ("deterministic", self.deterministic)]
        on = [name for name, v in flags if v]
        return "|".join(on) if on else "-"


@dataclasses.dataclass(frozen=True)
class NullConfig:
    """Config of a partitioner with no hyperparameters."""


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """Config of the ``+f`` combinator: run the base method, split every
    partition into its connected components, fuse back down to k (paper
    §5.4). ``base_k`` optionally gives the base method another target
    partition count than the final k."""
    alpha: float = dataclasses.field(
        default=0.05, metadata={"help": "balance slack: max part size is "
                                        "(n/k)*(1+alpha)"})
    base_k: Optional[int] = dataclasses.field(
        default=None, metadata={"help": "k handed to the base method "
                                        "(default: the final k)"})

    def __post_init__(self):
        if not (self.alpha >= 0.0):
            raise ValueError(f"alpha must be >= 0, got {self.alpha}")
        if self.base_k is not None and self.base_k < 1:
            raise ValueError(f"base_k must be >= 1, got {self.base_k}")


@dataclasses.dataclass(frozen=True)
class RegisteredPartitioner:
    """One registry entry: the function plus its typed config and flags."""
    name: str
    fn: Callable[[Graph, int, int, Any], np.ndarray]
    config_type: Type[Any]
    capabilities: Capabilities
    doc: str = ""

    def partition(self, g: Graph, k: int, seed: int = 0,
                  config: Optional[Any] = None):
        """Run the method; returns a
        :class:`repro_torch.core.spec.PartitionResult`."""
        from .spec import PartitionerSpec
        cfg = self.config_type() if config is None else config
        if not isinstance(cfg, self.config_type):
            raise TypeError(f"partitioner {self.name!r} expects a "
                            f"{self.config_type.__name__}, got "
                            f"{type(cfg).__name__}")
        return PartitionerSpec(method=self.name, config=cfg).partition(
            g, k, seed=seed)


_REGISTRY: Dict[str, RegisteredPartitioner] = {}


def _key(name: str) -> str:
    return name.lower().replace("-", "_")


def register_partitioner(name: str, *, config: Type[Any] = NullConfig,
                         capabilities: Capabilities = Capabilities(),
                         doc: str = "", overwrite: bool = False):
    """Decorator: register ``fn(g, k, seed, cfg) -> labels`` under ``name``."""
    key = _key(name)
    if not dataclasses.is_dataclass(config):
        raise TypeError(f"config for {name!r} must be a dataclass, "
                        f"got {config!r}")

    def deco(fn):
        if key in _REGISTRY and not overwrite:
            raise ValueError(f"partitioner {key!r} already registered; "
                             f"pass overwrite=True to replace it")
        _REGISTRY[key] = RegisteredPartitioner(
            name=key, fn=fn, config_type=config, capabilities=capabilities,
            doc=doc or (fn.__doc__ or "").strip().split("\n")[0])
        return fn
    return deco


def unregister_partitioner(name: str) -> None:
    _REGISTRY.pop(_key(name), None)


def registered_partitioners() -> Dict[str, RegisteredPartitioner]:
    """Snapshot of the registry (name -> entry), sorted by name."""
    return {k: _REGISTRY[k] for k in sorted(_REGISTRY)}


def get_entry(name: str) -> RegisteredPartitioner:
    try:
        return _REGISTRY[_key(name)]
    except KeyError:
        raise ValueError(f"unknown partitioner {name!r}; available: "
                         f"{sorted(_REGISTRY)}") from None
