"""Partition-sharded embedding store.

One pipeline run exports a **serving bundle** — pooled node embeddings, the
classifier MLP, the k per-partition heads, the partition assignment and the
offline answer key — as one ``.npz`` in the reference package's format, so
a bundle written by either package loads in the other.
:class:`EmbeddingStore` loads it as k shards whose embedding rows, and the
heads and classifier, live on the device; node ids route through
``partition_of`` (on the host) to their owning shard.

Two fingerprints guard staleness, both hard errors at load time: the
partitioner's config fingerprint and, when the caller has the graph, the
graph fingerprint.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.gnn.model import mlp_forward

__all__ = ["SERVING_VERSION", "CLASSIFY_ROWS", "StaleServingArtifact",
           "ShardStore", "EmbeddingStore", "classify",
           "export_serving_bundle", "export_from_pipeline"]

SERVING_VERSION = 1

#: Rows per classifier call. The offline answer key and the served path
#: both run the classifier on blocks of exactly this many rows, so both see
#: the same matrix-product shapes, hence the same algorithm and the same
#: bits per row, whatever the batch size.
CLASSIFY_ROWS = 64


class StaleServingArtifact(RuntimeError):
    """A serving bundle whose fingerprints do not match the request."""


@torch.no_grad()
def classify(classifier: Dict[str, torch.Tensor],
             emb: torch.Tensor) -> torch.Tensor:
    """Classifier logits for ``emb`` [B, E], computed block by block on
    zero-padded ``[CLASSIFY_ROWS, E]`` blocks (see ``CLASSIFY_ROWS``)."""
    b = emb.shape[0]
    padded = -(-b // CLASSIFY_ROWS) * CLASSIFY_ROWS
    x = torch.zeros((padded, emb.shape[1]), dtype=torch.float32,
                    device=emb.device)
    x[:b] = emb
    out = [mlp_forward(classifier, x[i:i + CLASSIFY_ROWS])
           for i in range(0, padded, CLASSIFY_ROWS)]
    return torch.cat(out)[:b]


def _atomic_savez(path: str, **arrays) -> None:
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def export_serving_bundle(directory: str, *, part_labels: np.ndarray,
                          embeddings: np.ndarray, predictions: np.ndarray,
                          head_w: np.ndarray, head_b: np.ndarray,
                          classifier: Dict[str, np.ndarray],
                          meta: Dict[str, Any]) -> str:
    """Write one bundle under ``directory`` (atomically); returns its path.
    The filename carries the partition fingerprint."""
    meta = {"kind": "serving", "version": SERVING_VERSION, **meta}
    fp = meta.get("partition_fingerprint") or "nofp"
    path = os.path.join(directory, f"serving-{fp}.npz")
    _atomic_savez(
        path,
        meta_json=np.asarray(json.dumps(meta, sort_keys=True)),
        part_labels=np.asarray(part_labels, np.int32),
        embeddings=np.asarray(embeddings, np.float32),
        predictions=np.asarray(predictions, np.int32),
        head_w=np.asarray(head_w, np.float32),
        head_b=np.asarray(head_b, np.float32),
        **{f"clf_{k}": np.asarray(v, np.float32)
           for k, v in classifier.items()})
    return path


def export_from_pipeline(directory: str, result, spec) -> str:
    """Write the bundle of one pipeline result (its predictions are the
    offline answer key). ``spec`` is the run's
    :class:`~repro_torch.core.PartitionerSpec`: the bundle carries its
    fingerprint and canonical string, as the reference package's does."""
    from repro_torch.pipeline.datasets import graph_fingerprint

    ds = result.dataset

    def host(t):
        return t.detach().cpu().numpy()
    meta = {
        "partition_fingerprint": spec.fingerprint(),
        "spec": spec.canonical(),
        "graph": graph_fingerprint(ds.graph),
        "dataset": ds.name,
        "n": int(ds.graph.n),
        "k": int(result.batch.k),
        "num_classes": int(ds.num_classes),
        "embed_dim": int(result.embeddings.shape[1]),
    }
    return export_serving_bundle(
        directory, part_labels=result.labels,
        embeddings=host(result.embeddings), predictions=result.predictions,
        head_w=host(result.params["head"]["w"]),
        head_b=host(result.params["head"]["b"]),
        classifier={k: host(v) for k, v in result.classifier.items()},
        meta=meta)


@dataclasses.dataclass(frozen=True)
class ShardStore:
    """One partition's owned rows (on the device) and its trained head."""
    pid: int
    node_ids: np.ndarray         # [m] global ids owned by this shard, sorted
    embeddings: torch.Tensor     # [m, E] rows aligned with node_ids
    head_w: torch.Tensor         # [E, C]
    head_b: torch.Tensor         # [C]

    @property
    def num_nodes(self) -> int:
        return int(self.node_ids.shape[0])


class EmbeddingStore:
    """k-sharded read view of one serving bundle, on one device."""

    def __init__(self, meta: Dict[str, Any], part_labels: np.ndarray,
                 embeddings: np.ndarray, predictions: np.ndarray,
                 head_w: np.ndarray, head_b: np.ndarray,
                 classifier: Dict[str, np.ndarray],
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)

        def dev(x):
            return torch.as_tensor(np.ascontiguousarray(x),
                                   dtype=torch.float32).to(self.device)
        self.meta = meta
        self.n = int(part_labels.shape[0])
        self.k = int(head_w.shape[0])
        self.embed_dim = int(embeddings.shape[1])
        self.num_classes = int(head_w.shape[2])
        self.partition_of = part_labels.astype(np.int32)
        self.predictions = predictions.astype(np.int32)
        self.classifier = {k: dev(v) for k, v in classifier.items()}
        self.head_w = dev(head_w)        # [k, E, C]
        self.head_b = dev(head_b)        # [k, C]
        self._local_row = np.zeros(self.n, dtype=np.int64)
        self.shards: List[ShardStore] = []
        for p in range(self.k):
            owned = np.flatnonzero(self.partition_of == p)
            self._local_row[owned] = np.arange(owned.shape[0])
            self.shards.append(ShardStore(
                pid=p, node_ids=owned, embeddings=dev(embeddings[owned]),
                head_w=self.head_w[p], head_b=self.head_b[p]))

    @classmethod
    def load(cls, path: str, device: DeviceLike = "cuda",
             expect_fingerprint: Optional[str] = None,
             expect_graph: Optional[str] = None) -> "EmbeddingStore":
        """Load a bundle file (or the matching/newest bundle in a
        directory); fingerprint mismatches raise
        :class:`StaleServingArtifact`."""
        path = cls.resolve(path, expect_fingerprint)
        with np.load(path, allow_pickle=False) as z:
            data = {k: z[k] for k in z.files}
        meta = json.loads(str(data.pop("meta_json")))
        if meta.get("kind") != "serving" or \
                meta.get("version") != SERVING_VERSION:
            raise StaleServingArtifact(
                f"{path}: not a v{SERVING_VERSION} serving bundle "
                f"(meta={meta.get('kind')!r} v{meta.get('version')!r})")
        if expect_fingerprint is not None and \
                meta.get("partition_fingerprint") != expect_fingerprint:
            raise StaleServingArtifact(
                f"{path}: partition fingerprint "
                f"{meta.get('partition_fingerprint')!r} != expected "
                f"{expect_fingerprint!r} — re-export the bundle")
        if expect_graph is not None and meta.get("graph") != expect_graph:
            raise StaleServingArtifact(
                f"{path}: graph fingerprint mismatch — the bundle was "
                f"exported from a different graph")
        classifier = {k[len("clf_"):]: v for k, v in data.items()
                      if k.startswith("clf_")}
        return cls(meta, data["part_labels"], data["embeddings"],
                   data["predictions"], data["head_w"], data["head_b"],
                   classifier, device=device)

    @staticmethod
    def resolve(path: str, expect_fingerprint: Optional[str] = None) -> str:
        """A file is taken as-is; a directory yields the fingerprint's
        bundle, or the newest one when no fingerprint is expected."""
        if not os.path.isdir(path):
            return path
        if expect_fingerprint:
            cand = os.path.join(path, f"serving-{expect_fingerprint}.npz")
            if not os.path.exists(cand):
                raise StaleServingArtifact(
                    f"no serving bundle for fingerprint "
                    f"{expect_fingerprint!r} under {path}")
            return cand
        bundles = sorted(
            (os.path.getmtime(os.path.join(path, f)), os.path.join(path, f))
            for f in os.listdir(path)
            if f.startswith("serving-") and f.endswith(".npz"))
        if not bundles:
            raise FileNotFoundError(f"no serving bundles under {path}")
        return bundles[-1][1]

    @property
    def fingerprint(self) -> str:
        return self.meta.get("partition_fingerprint", "")

    def is_known(self, node_id: int) -> bool:
        return 0 <= node_id < self.n

    def lookup(self, node_ids: np.ndarray) -> torch.Tensor:
        """Embeddings of known nodes ``[len, E]`` on the device, gathered
        shard by shard."""
        ids = np.asarray(node_ids, dtype=np.int64)
        out = torch.empty((ids.shape[0], self.embed_dim),
                          dtype=torch.float32, device=self.device)
        pids = self.partition_of[ids]
        for p in np.unique(pids):
            sel = np.flatnonzero(pids == p)
            rows = torch.as_tensor(self._local_row[ids[sel]]).to(self.device)
            out[torch.as_tensor(sel).to(self.device)] = \
                self.shards[p].embeddings[rows]
        return out

    def summary(self) -> str:
        rows = ", ".join(f"p{s.pid}:{s.num_nodes}" for s in self.shards)
        return (f"EmbeddingStore(n={self.n}, k={self.k}, "
                f"E={self.embed_dim}, C={self.num_classes}, "
                f"fp={self.fingerprint}, device={self.device}, "
                f"shards=[{rows}])")
