"""The Leiden-Fusion partitioner behind a typed config.

``LeidenFusionConfig.fingerprint()`` hashes the method name and the full
config exactly as the reference package's partitioner spec does, so a
serving bundle exported by either package carries the same partition
fingerprint and loads in the other.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np

from .fusion import leiden_fusion
from .graph import Graph

METHOD = "leiden_fusion"


@dataclasses.dataclass(frozen=True)
class LeidenFusionConfig:
    alpha: float = 0.05         # max part size is (n/k)*(1+alpha)
    beta: float = 0.5           # Leiden size cap as a fraction of that
    resolution: float = 1.0     # Leiden modularity resolution gamma

    def __post_init__(self):
        if not (self.alpha >= 0.0):
            raise ValueError(f"alpha must be >= 0, got {self.alpha}")
        if not (0.0 < self.beta <= 1.0):
            raise ValueError(f"beta must be in (0, 1], got {self.beta}")
        if not (self.resolution > 0.0):
            raise ValueError(f"resolution must be > 0, "
                             f"got {self.resolution}")

    def canonical(self) -> str:
        """Spec string: the method name, with the non-default fields."""
        args = [f"{f.name}={getattr(self, f.name)!r}"
                for f in dataclasses.fields(self)
                if getattr(self, f.name) != f.default]
        return METHOD + (f"({','.join(args)})" if args else "")

    def fingerprint(self) -> str:
        """16-hex-char digest of the method name and the full config."""
        payload = {"method": METHOD, "config": dataclasses.asdict(self),
                   "fusion": None}
        blob = json.dumps(payload, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]


def partition(g: Graph, k: int, seed: int = 0,
              cfg: LeidenFusionConfig = LeidenFusionConfig()) -> np.ndarray:
    """Leiden-Fusion labels (n,) int64 with values in [0, k)."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    return np.asarray(leiden_fusion(g, k, alpha=cfg.alpha, beta=cfg.beta,
                                    seed=seed, gamma=cfg.resolution),
                      dtype=np.int64)
