"""Vectorized partitioning engine (numpy): the quotient-graph builder, the
array union-find for connected components, and the mutable community state
that drives Fusion.

* :func:`quotient_edges` — deduped inter-community arcs via one ``argsort``
  + ``add.reduceat`` pass, plus per-community internal and node weight.
* :func:`connected_components` — min-hooking union-find with pointer
  jumping; components are numbered in increasing order of their smallest
  member node (the order a BFS would seed them in).
* :class:`CommunityState` — labels, per-community sizes and degrees, and a
  community adjacency held as per-community sorted arrays, merged
  incrementally with stale ids resolved lazily through a union-find.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["QuotientEdges", "quotient_edges", "connected_components",
           "split_components", "CommunityState"]


@dataclasses.dataclass(frozen=True)
class QuotientEdges:
    """Deduped community-level arcs for one labelling of a graph.

    ``src``/``dst``/``weight`` hold every directed inter-community arc once
    (both directions present, sorted by ``(src, dst)``). ``intra`` is the
    per-community internal weight in undirected terms (member self-loops
    included) and ``node_weight`` the per-community sum of node weights.
    """
    k: int
    src: np.ndarray           # (q,) int64
    dst: np.ndarray           # (q,) int64
    weight: np.ndarray        # (q,) float64
    intra: np.ndarray         # (k,) float64
    node_weight: np.ndarray   # (k,) float64

    def indptr(self) -> np.ndarray:
        """CSR row pointers over ``src`` (valid because src is sorted)."""
        counts = np.bincount(self.src, minlength=self.k)
        out = np.zeros(self.k + 1, dtype=np.int64)
        np.cumsum(counts, out=out[1:])
        return out


def quotient_edges(g, labels: np.ndarray) -> QuotientEdges:
    """The single quotient-graph/cut computation (see module docstring)."""
    labels = np.asarray(labels, dtype=np.int64)
    k = int(labels.max()) + 1 if labels.size else 0
    sw = g.self_weight
    if sw.shape[0] != g.n:     # Graph's zero-length default
        sw = np.zeros(g.n)
    src, dst, w = g.arcs()
    ls, ld = labels[src], labels[dst]
    inter = ls != ld
    key = ls[inter] * k + ld[inter]
    order = np.argsort(key, kind="stable")
    key = key[order]
    ws = w[inter][order]
    if key.size:
        starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
        qw = np.add.reduceat(ws, starts)
        qk = key[starts]
        qs, qd = qk // k, qk % k
    else:
        qs = qd = np.zeros(0, dtype=np.int64)
        qw = np.zeros(0, dtype=np.float64)
    # intra arcs appear twice (both directions) -> /2 for undirected weight,
    # plus any member self-loops
    intra = np.bincount(ls[~inter], weights=w[~inter], minlength=k) / 2.0
    intra += np.bincount(labels, weights=sw, minlength=k)
    node_w = np.bincount(labels, weights=g.node_weight, minlength=k)
    return QuotientEdges(k=k, src=qs, dst=qd, weight=qw, intra=intra,
                         node_weight=node_w)


def _pointer_jump(parent: np.ndarray) -> np.ndarray:
    while True:
        jumped = parent[parent]
        if np.array_equal(jumped, parent):
            return parent
        parent = jumped


def connected_components(n: int, src: np.ndarray, dst: np.ndarray,
                         mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Component labels via min-hooking union-find over the given arcs.

    Components are numbered 0..k-1 in increasing order of their smallest
    member node; nodes outside ``mask`` get -1.
    """
    parent = np.arange(n, dtype=np.int64)
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if mask is not None:
        keep = mask[src] & mask[dst]
        src, dst = src[keep], dst[keep]
    while src.size:
        ps, pd = parent[src], parent[dst]
        hooked = ps != pd
        if not hooked.any():
            break
        hi = np.maximum(ps, pd)[hooked]
        lo = np.minimum(ps, pd)[hooked]
        np.minimum.at(parent, hi, lo)
        parent = _pointer_jump(parent)
    comp = np.full(n, -1, dtype=np.int64)
    m = np.ones(n, dtype=bool) if mask is None else np.asarray(mask, bool)
    if m.any():
        # roots are the min member of each component, so sorting by root
        # reproduces the BFS seed numbering
        _, ids = np.unique(parent[m], return_inverse=True)
        comp[m] = ids
    return comp


def split_components(g, labels: np.ndarray) -> np.ndarray:
    """Relabel so every connected component of every community is its own
    community (components of the same-label arc subgraph)."""
    labels = np.asarray(labels, dtype=np.int64)
    src, dst, _ = g.arcs()
    same = labels[src] == labels[dst]
    return connected_components(g.n, src[same], dst[same])


class CommunityState:
    """Labels + sizes/degrees + an incrementally merged community adjacency.

    A merge of ``b`` into ``a`` concatenates their neighbour lists and
    re-canonicalizes only ``a``; lists that still mention ``b`` are resolved
    lazily through the union-find when read.
    """

    def __init__(self, g, labels: np.ndarray,
                 sizes: Optional[np.ndarray] = None):
        labels = np.asarray(labels, dtype=np.int64)
        q = quotient_edges(g, labels)
        num = q.k
        self.num = num
        self.labels = labels
        if sizes is None:
            self.size = np.bincount(labels, minlength=num).astype(np.float64)
        else:
            self.size = np.asarray(sizes, dtype=np.float64).copy()
        # weighted degree per community = inter cut + 2 * intra weight
        self.degree = np.bincount(q.src, weights=q.weight,
                                  minlength=num).astype(np.float64)
        self.degree += 2.0 * q.intra
        self.alive = np.ones(num, dtype=bool)
        self.parent = np.arange(num, dtype=np.int64)
        indptr = q.indptr()
        self._nbrs: List[np.ndarray] = [
            q.dst[indptr[c]:indptr[c + 1]] for c in range(num)]
        self._wgts: List[np.ndarray] = [
            q.weight[indptr[c]:indptr[c + 1]] for c in range(num)]

    def _resolve(self, ids: np.ndarray) -> np.ndarray:
        """Map (possibly stale) community ids to their live roots."""
        while True:
            up = self.parent[ids]
            if np.array_equal(up, ids):
                return ids
            ids = up

    def roots(self) -> np.ndarray:
        return self._resolve(np.arange(self.num, dtype=np.int64))

    def compact_labels(self) -> np.ndarray:
        """Node labels remapped through the merges, compacted to 0..k-1."""
        _, compact = np.unique(self.roots(), return_inverse=True)
        return compact[self.labels]

    def _canonicalize(self, c: int) -> None:
        ids = self._resolve(self._nbrs[c])
        ws = self._wgts[c]
        live = ids != c                     # merged-in entries became intra
        ids, ws = ids[live], ws[live]
        if ids.size > 1:
            order = np.argsort(ids, kind="stable")
            ids, ws = ids[order], ws[order]
            starts = np.flatnonzero(np.r_[True, ids[1:] != ids[:-1]])
            ids = ids[starts]
            ws = np.add.reduceat(ws, starts)
        self._nbrs[c], self._wgts[c] = ids, ws

    def neighbors(self, c: int) -> Tuple[np.ndarray, np.ndarray]:
        """(live neighbour ids, cut weights) of live community ``c``."""
        self._canonicalize(c)
        return self._nbrs[c], self._wgts[c]

    def merge(self, b: int, into: int) -> None:
        """Merge live community ``b`` into live community ``into``."""
        a = int(into)
        b = int(b)
        self.parent[b] = a
        self.alive[b] = False
        self.size[a] += self.size[b]
        self.degree[a] += self.degree[b]
        self._nbrs[a] = np.concatenate([self._nbrs[a], self._nbrs[b]])
        self._wgts[a] = np.concatenate([self._wgts[a], self._wgts[b]])
        self._nbrs[b] = np.zeros(0, dtype=np.int64)
        self._wgts[b] = np.zeros(0, dtype=np.float64)
        self._canonicalize(a)
