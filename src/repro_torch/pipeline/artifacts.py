"""Partition artifact store: partition once, reuse in every later run.

Two artifact kinds live under one cache directory as content-addressed
bundle directories (``meta.json`` and one ``.npy`` per array, written
atomically):

* **labels bundle**: the partition assignment, keyed by ``(graph hash,
  canonical spec, config fingerprint, k, seed)``. Partitioning is the
  expensive stage, so it is cached apart from the assembly scheme:
  ``inner`` and ``repli`` runs share one partitioning.
* **batch bundle**: the padded :class:`~repro_torch.core.PartitionBatch`
  arrays, keyed by the scheme too, and the halo exchange plan of the sync
  and stale modes (``halo_send_rows``, ``halo_recv_rows``, ``halo_h_pad``)
  when a run asked for it. A batch hit that lacks the plan is still a hit:
  the plan is built and the bundle rewritten with it.

The key, its digest, the bundle names, the array names and the layout are
the reference package's (``ARTIFACT_VERSION`` 5), so an entry written by
either package is a hit in the other, its halo plan included. Loads check
the stored metadata against the requested key and treat any mismatch as a
miss. Arrays load into memory (the reference maps them; the port leaves
out-of-core paths out).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import re
import shutil
import tempfile
import time
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np

from repro_torch.core import (Graph, HaloExchangeSpec, PartitionBatch,
                              PartitionerSpec, build_halo_exchange,
                              build_partition_batch, partition_from_spec)

from .datasets import graph_fingerprint

__all__ = ["ARTIFACT_VERSION", "ArtifactBundle", "PartitionArtifactStore",
           "atomic_directory", "compute_bundle"]

log = logging.getLogger("repro_torch.pipeline")

ARTIFACT_VERSION = 5

_BATCH_FIELDS = ("node_ids", "node_mask", "owned_mask", "edge_src",
                 "edge_dst", "edge_weight", "in_degree")
_HALO_FIELDS = ("halo_send_rows", "halo_recv_rows", "halo_h_pad")

SpecLike = Union[str, PartitionerSpec]


class atomic_directory:
    """``with atomic_directory(final) as tmp: ...``: populate ``tmp``; on a
    clean exit it is renamed to ``final`` in one ``os.replace``. On error
    the temporary tree is deleted and ``final`` is untouched."""

    def __init__(self, final_path: str):
        self.final = os.path.abspath(final_path)
        self.tmp: Optional[str] = None

    def __enter__(self) -> str:
        parent = os.path.dirname(self.final) or "."
        os.makedirs(parent, exist_ok=True)
        self.tmp = tempfile.mkdtemp(
            dir=parent, prefix=os.path.basename(self.final) + ".tmp-")
        return self.tmp

    def __exit__(self, exc_type, exc, tb) -> None:
        assert self.tmp is not None
        if exc_type is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)
            return
        if os.path.isdir(self.final):
            # move the old bundle aside so the final rename stays atomic
            old = self.tmp + ".old"
            os.replace(self.final, old)
            os.replace(self.tmp, self.final)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.replace(self.tmp, self.final)


@dataclasses.dataclass(frozen=True)
class ArtifactBundle:
    """What the training stage needs, and where it came from."""
    labels: np.ndarray
    batch: PartitionBatch
    halo: Optional[HaloExchangeSpec]    # sync and stale modes only
    labels_hit: bool
    batch_hit: bool
    labels_path: Optional[str]
    batch_path: Optional[str]
    partition_seconds: float
    assemble_seconds: float
    spec: str = ""                  # canonical partitioner spec
    fingerprint: str = ""           # the spec's config fingerprint


def _digest(meta: Dict[str, Any]) -> str:
    blob = json.dumps(meta, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def _spec_slug(spec: PartitionerSpec) -> str:
    """Filesystem-safe, readable prefix from the canonical spec."""
    slug = re.sub(r"[^A-Za-z0-9_.+=-]+", "_", spec.canonical()).strip("_")
    return slug[:60] or "partition"


def compute_bundle(g: Graph, method: SpecLike, k: int, seed: int,
                   scheme: str, with_halo: bool = False) -> ArtifactBundle:
    """Partition and assemble (and plan the halo exchange when
    ``with_halo``) with no cache."""
    spec = PartitionerSpec.parse(method)
    result = partition_from_spec(g, spec, k, seed)
    t0 = time.time()
    batch = build_partition_batch(g, result.labels, scheme=scheme)
    halo = build_halo_exchange(g, result.labels, batch) if with_halo \
        else None
    return ArtifactBundle(labels=result.labels, batch=batch, halo=halo,
                          labels_hit=False, batch_hit=False,
                          labels_path=None, batch_path=None,
                          partition_seconds=result.seconds,
                          assemble_seconds=time.time() - t0,
                          spec=spec.canonical(),
                          fingerprint=spec.fingerprint())


class PartitionArtifactStore:
    """Load-or-compute cache of partition artifacts under ``cache_dir``."""

    def __init__(self, cache_dir: str):
        self.cache_dir = os.path.abspath(os.path.expanduser(cache_dir))
        os.makedirs(self.cache_dir, exist_ok=True)

    # -- keys and paths --------------------------------------------------
    def _labels_meta(self, graph_hash: str, spec: PartitionerSpec, k: int,
                     seed: int) -> Dict[str, Any]:
        return {"kind": "labels", "version": ARTIFACT_VERSION,
                "graph": graph_hash, "spec": spec.canonical(),
                "config_fp": spec.fingerprint(), "k": int(k),
                "seed": int(seed)}

    def _batch_meta(self, graph_hash: str, spec: PartitionerSpec, k: int,
                    seed: int, scheme: str) -> Dict[str, Any]:
        return {**self._labels_meta(graph_hash, spec, k, seed),
                "kind": "batch", "scheme": scheme}

    def _path(self, meta: Dict[str, Any], spec: PartitionerSpec) -> str:
        stem = f"{meta['kind']}-{_spec_slug(spec)}-k{meta['k']}-s{meta['seed']}"
        if meta["kind"] == "batch":
            stem += f"-{meta['scheme']}"
        return os.path.join(self.cache_dir, f"{stem}-{_digest(meta)}")

    # -- bundle IO -------------------------------------------------------
    @staticmethod
    def _save_bundle(path: str, meta: Dict[str, Any],
                     arrays: Dict[str, np.ndarray]) -> None:
        with atomic_directory(path) as tmp:
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f, indent=1, sort_keys=True)
            for name, arr in arrays.items():
                np.save(os.path.join(tmp, name + ".npy"), arr)

    @staticmethod
    def _load_bundle(path: str, meta: Dict[str, Any],
                     required: Tuple[str, ...],
                     optional: Tuple[str, ...] = ()
                     ) -> Optional[Dict[str, np.ndarray]]:
        """The bundle's required arrays and those of ``optional`` it holds,
        or None (a miss) when it is absent, unreadable, incomplete or keyed
        otherwise."""
        if not os.path.isdir(path):
            return None
        try:
            with open(os.path.join(path, "meta.json")) as f:
                stored = json.load(f)
            if stored != meta:
                log.warning("stale artifact %s (key mismatch), recomputing",
                            path)
                return None
            names = required + tuple(
                n for n in optional
                if os.path.exists(os.path.join(path, n + ".npy")))
            return {name: np.load(os.path.join(path, name + ".npy"),
                                  allow_pickle=False) for name in names}
        except (OSError, ValueError) as e:
            log.warning("unreadable artifact %s (%r), recomputing", path, e)
            return None

    # -- labels ----------------------------------------------------------
    def load_or_partition(self, g: Graph, method: SpecLike, k: int, seed: int,
                          graph_hash: Optional[str] = None
                          ) -> Tuple[np.ndarray, bool, str, float]:
        """Returns (labels, cache_hit, path, partition_seconds)."""
        spec = PartitionerSpec.parse(method)
        graph_hash = graph_hash or graph_fingerprint(g)
        meta = self._labels_meta(graph_hash, spec, k, seed)
        path = self._path(meta, spec)
        data = self._load_bundle(path, meta, ("labels",))
        if data is not None:
            log.info("partition cache HIT: %s (spec=%s fp=%s k=%d seed=%d)",
                     path, spec.canonical(), spec.fingerprint(), k, seed)
            return np.asarray(data["labels"], dtype=np.int64), True, path, 0.0
        log.info("partition cache MISS: computing %s k=%d seed=%d",
                 spec.canonical(), k, seed)
        result = partition_from_spec(g, spec, k, seed)
        self._save_bundle(path, meta, {"labels": result.labels})
        return result.labels, False, path, result.seconds

    # -- batch -----------------------------------------------------------
    def load_or_assemble(self, g: Graph, labels: np.ndarray,
                         method: SpecLike, k: int, seed: int, scheme: str,
                         with_halo: bool = False,
                         graph_hash: Optional[str] = None
                         ) -> Tuple[PartitionBatch, Optional[HaloExchangeSpec],
                                    bool, str, float]:
        """Returns (batch, halo, cache_hit, path, assemble_seconds); the
        halo plan is None unless asked for or stored."""
        spec = PartitionerSpec.parse(method)
        graph_hash = graph_hash or graph_fingerprint(g)
        meta = self._batch_meta(graph_hash, spec, k, seed, scheme)
        path = self._path(meta, spec)
        data = self._load_bundle(path, meta, _BATCH_FIELDS + ("n_pad",
                                                              "e_pad"),
                                 _HALO_FIELDS)
        if data is not None:
            batch = PartitionBatch(
                **{f: data[f] for f in _BATCH_FIELDS},
                n_pad=int(data["n_pad"]), e_pad=int(data["e_pad"]))
            halo = None
            if all(f in data for f in _HALO_FIELDS):
                halo = HaloExchangeSpec(send_rows=data["halo_send_rows"],
                                        recv_rows=data["halo_recv_rows"],
                                        h_pad=int(data["halo_h_pad"]))
            if with_halo and halo is None:
                log.info("batch cache HIT (adding the halo plan): %s", path)
                halo = build_halo_exchange(g, labels, batch)
                self._save_batch(path, meta, batch, halo)
            else:
                log.info("batch cache HIT: %s", path)
            return batch, halo, True, path, 0.0
        log.info("batch cache MISS: assembling scheme=%s", scheme)
        t0 = time.time()
        batch = build_partition_batch(g, labels, scheme=scheme)
        halo = build_halo_exchange(g, labels, batch) if with_halo else None
        secs = time.time() - t0
        self._save_batch(path, meta, batch, halo)
        return batch, halo, False, path, secs

    def _save_batch(self, path: str, meta: Dict[str, Any],
                    batch: PartitionBatch,
                    halo: Optional[HaloExchangeSpec]) -> None:
        arrays = {f: np.asarray(getattr(batch, f)) for f in _BATCH_FIELDS}
        arrays["n_pad"] = np.int64(batch.n_pad)
        arrays["e_pad"] = np.int64(batch.e_pad)
        if halo is not None:
            arrays["halo_send_rows"] = np.asarray(halo.send_rows)
            arrays["halo_recv_rows"] = np.asarray(halo.recv_rows)
            arrays["halo_h_pad"] = np.int64(halo.h_pad)
        self._save_bundle(path, meta, arrays)

    # -- one call --------------------------------------------------------
    def load_or_compute(self, g: Graph, method: SpecLike, k: int, seed: int,
                        scheme: str, with_halo: bool = False
                        ) -> ArtifactBundle:
        spec = PartitionerSpec.parse(method)
        graph_hash = graph_fingerprint(g)
        labels, lhit, lpath, t_part = self.load_or_partition(
            g, spec, k, seed, graph_hash=graph_hash)
        batch, halo, bhit, bpath, t_asm = self.load_or_assemble(
            g, labels, spec, k, seed, scheme, with_halo=with_halo,
            graph_hash=graph_hash)
        return ArtifactBundle(labels=labels, batch=batch, halo=halo,
                              labels_hit=lhit,
                              batch_hit=bhit, labels_path=lpath,
                              batch_path=bpath, partition_seconds=t_part,
                              assemble_seconds=t_asm, spec=spec.canonical(),
                              fingerprint=spec.fingerprint())

    # -- maintenance -----------------------------------------------------
    def entries(self):
        """(name, size_bytes) of every bundle in the cache: bundle
        directories, and any ``.npz`` bundles of the older format."""
        out = []
        for name in sorted(os.listdir(self.cache_dir)):
            p = os.path.join(self.cache_dir, name)
            if os.path.isdir(p) and ".tmp-" not in name:
                size = sum(os.path.getsize(os.path.join(root, f))
                           for root, _, fnames in os.walk(p) for f in fnames)
                out.append((name, size))
            elif name.endswith(".npz"):
                out.append((name, os.path.getsize(p)))
        return out

    def clear(self) -> int:
        n = 0
        for name, _ in self.entries():
            p = os.path.join(self.cache_dir, name)
            if os.path.isdir(p):
                shutil.rmtree(p)
            else:
                os.unlink(p)
            n += 1
        return n
