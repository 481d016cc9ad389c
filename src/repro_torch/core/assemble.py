"""Per-partition subgraph assembly (numpy).

Builds, for every partition, the *Inner* (cut edges dropped) or *Repli*
(owned nodes plus their 1-hop halo, whose features are frozen inputs)
subgraph, padded to one static shape so the k subgraphs stack:

  - ``node_ids``  [k, N_pad] original node ids, -1 for padding;
  - arcs are destination-sorted local ``(src, dst)`` lists; padding arcs
    carry weight 0 and are parked at row ``n_pad - 1``, which keeps
    ``edge_dst`` sorted;
  - ``owned_mask`` is True for nodes the partition owns (embedding rows);
    halo replicas appear in Repli batches with ``owned=False``.

It also plans the halo exchange of the sync and stale training modes
(``build_halo_exchange``: which rows every partition sends every peer, and
where they land), and holds the model-integration step that averages the
k trained partition models (``average_partition_params``,
``integrate_models``), on stacked parameter tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import tree_map

from .graph import Graph

INTEGRATION_KINDS = ("none", "model_avg", "ensemble")


@dataclasses.dataclass(frozen=True)
class PartitionBatch:
    """Static-shape batch of k partition subgraphs (numpy)."""
    node_ids: np.ndarray      # [k, N_pad] int32, -1 = padding
    node_mask: np.ndarray     # [k, N_pad] bool, valid node
    owned_mask: np.ndarray    # [k, N_pad] bool, owned (not halo) node
    edge_src: np.ndarray      # [k, E_pad] int32 local src (gather index)
    edge_dst: np.ndarray      # [k, E_pad] int32 local dst, sorted
    edge_weight: np.ndarray   # [k, E_pad] f32, 0 for padding
    in_degree: np.ndarray     # [k, N_pad] f32 (GCN mean normalization)
    n_pad: int
    e_pad: int

    @property
    def k(self) -> int:
        return int(self.node_ids.shape[0])


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def build_partition_batch(g: Graph, labels: np.ndarray, scheme: str = "inner",
                          pad_nodes_to: Optional[int] = None,
                          pad_edges_to: Optional[int] = None,
                          align: int = 8) -> PartitionBatch:
    """Assemble the k padded subgraphs for ``scheme`` in {'inner','repli'}."""
    if scheme not in ("inner", "repli"):
        raise ValueError(f"scheme must be inner|repli, got {scheme!r}")
    labels = np.asarray(labels, dtype=np.int64)
    k = int(labels.max()) + 1
    src, dst, w = g.arcs()          # every directed arc (u -> v)

    node_lists = []
    owned_lists = []
    arc_lists = []
    for p in range(k):
        owned = np.where(labels == p)[0]
        owned_set = np.zeros(g.n, dtype=bool)
        owned_set[owned] = True
        if scheme == "inner":
            keep = owned_set[src] & owned_set[dst]
            nodes = owned
            owned_flags = np.ones(nodes.shape[0], dtype=bool)
        else:
            # Repli: keep every arc whose dst is owned (halo feeds owned
            # nodes); arcs into halo nodes are dropped
            keep = owned_set[dst]
            halo = np.unique(src[keep & ~owned_set[src]])
            nodes = np.concatenate([owned, halo])
            owned_flags = np.concatenate([
                np.ones(owned.shape[0], dtype=bool),
                np.zeros(halo.shape[0], dtype=bool)])
        remap = np.full(g.n, -1, dtype=np.int64)
        remap[nodes] = np.arange(nodes.shape[0])
        ls, ld, lw = remap[src[keep]], remap[dst[keep]], w[keep]
        order = np.argsort(ld, kind="stable")
        arc_lists.append((ls[order], ld[order], lw[order]))
        node_lists.append(nodes)
        owned_lists.append(owned_flags)

    n_max = max(x.shape[0] for x in node_lists)
    e_max = max(x[0].shape[0] for x in arc_lists)
    n_pad = pad_nodes_to or _round_up(max(n_max, 1), align)
    e_pad = pad_edges_to or _round_up(max(e_max, 1), align)
    if n_max > n_pad or e_max > e_pad:
        raise ValueError(f"padding too small: need nodes>={n_max} "
                         f"edges>={e_max}")

    node_ids = np.full((k, n_pad), -1, dtype=np.int32)
    node_mask = np.zeros((k, n_pad), dtype=bool)
    owned_mask = np.zeros((k, n_pad), dtype=bool)
    edge_src = np.zeros((k, e_pad), dtype=np.int32)
    edge_dst = np.full((k, e_pad), n_pad - 1, dtype=np.int32)  # park padding
    edge_weight = np.zeros((k, e_pad), dtype=np.float32)
    in_degree = np.zeros((k, n_pad), dtype=np.float32)

    for p in range(k):
        nodes, owned_flags = node_lists[p], owned_lists[p]
        ls, ld, lw = arc_lists[p]
        nn, ne = nodes.shape[0], ls.shape[0]
        node_ids[p, :nn] = nodes
        node_mask[p, :nn] = True
        owned_mask[p, :nn] = owned_flags
        edge_src[p, :ne] = ls
        edge_dst[p, :ne] = ld
        edge_weight[p, :ne] = lw
        np.add.at(in_degree[p], ld, 1.0)

    return PartitionBatch(node_ids=node_ids, node_mask=node_mask,
                          owned_mask=owned_mask, edge_src=edge_src,
                          edge_dst=edge_dst, edge_weight=edge_weight,
                          in_degree=in_degree, n_pad=n_pad, e_pad=e_pad)


@dataclasses.dataclass(frozen=True)
class HaloExchangeSpec:
    """The halo exchange of the sync and stale modes (per layer), in the
    reference's dense layout: ``send_rows[q, p, j]`` is the local row in
    ``q`` of the ``j``-th row ``q`` sends ``p``, and ``recv_rows[p, q, j]``
    the halo row of ``p`` it overwrites; both are -1 past the pair's
    count."""
    send_rows: np.ndarray   # [k, k, H_pad] int32, -1 = padding
    recv_rows: np.ndarray   # [k, k, H_pad] int32, -1 = padding
    h_pad: int


def build_halo_exchange(g: Graph, labels: np.ndarray,
                        batch: PartitionBatch) -> HaloExchangeSpec:
    """Plan the halo transfers of a Repli batch: every valid, not owned row
    of partition ``p`` is fetched from its owner ``q = labels[node]``.

    The arrays are byte-identical to the reference's
    ``build_halo_exchange``: each pair's rows in ascending order of the
    receiving row, ``h_pad`` the largest pair's count (at least 1).
    ``g`` is unused, as in the reference."""
    labels = np.asarray(labels, dtype=np.int64)
    k = batch.k
    ids = np.asarray(batch.node_ids, dtype=np.int64)
    # the local row of every node in every partition that holds it
    row_of = np.full((k, labels.shape[0]), -1, dtype=np.int64)
    for p in range(k):
        rows = np.nonzero(ids[p] >= 0)[0]
        row_of[p, ids[p, rows]] = rows
    plans = []
    for p in range(k):
        recv = np.nonzero(batch.node_mask[p] & ~batch.owned_mask[p])[0]
        owner = labels[ids[p, recv]]
        order = np.argsort(owner, kind="stable")
        recv, owner = recv[order], owner[order]
        send = row_of[owner, ids[p, recv]]
        if (send < 0).any():
            raise ValueError(f"partition {p} holds a halo node that its "
                             f"owner's partition does not hold")
        counts = np.bincount(owner, minlength=k)
        slot = np.arange(recv.shape[0]) - np.repeat(
            np.cumsum(counts) - counts, counts)
        plans.append((owner, slot, send, recv, counts))
    h_pad = max(max(int(pl[4].max(initial=0)) for pl in plans), 1)
    send_rows = np.full((k, k, h_pad), -1, dtype=np.int32)
    recv_rows = np.full((k, k, h_pad), -1, dtype=np.int32)
    for p, (owner, slot, send, recv, _) in enumerate(plans):
        send_rows[owner, p, slot] = send
        recv_rows[p, owner, slot] = recv
    return HaloExchangeSpec(send_rows=send_rows, recv_rows=recv_rows,
                            h_pad=h_pad)


def average_partition_params(params: Any,
                             weights: Optional[np.ndarray] = None) -> Any:
    """Parameter-average k stacked partition models.

    Every leaf carries a leading partition axis of size k. Returns a tree of
    the same shapes: the (optionally ``weights``-weighted) mean over that
    axis, broadcast back to all k rows, so it drops into every
    per-partition function unchanged. Averaging k equal replicas is a fixed
    point."""
    if weights is None:
        return tree_map(lambda x: x.float().mean(dim=0).expand_as(x)
                        .to(x.dtype).contiguous(), params)
    w = torch.as_tensor(np.asarray(weights), dtype=torch.float32)
    if w.dim() != 1:
        raise ValueError(f"weights must be 1-D, got shape {tuple(w.shape)}")
    w = w / torch.clamp(w.sum(), min=1e-12)

    def wavg(x):
        if w.shape[0] != x.shape[0]:
            raise ValueError(f"weights length {w.shape[0]} != partition "
                             f"axis {x.shape[0]}")
        wb = w.to(x.device).reshape((-1,) + (1,) * (x.dim() - 1))
        return (x.float() * wb).sum(dim=0).expand_as(x).to(x.dtype) \
            .contiguous()
    return tree_map(wavg, params)


def integrate_models(params: Any, kind: str = "model_avg",
                     weights: Optional[np.ndarray] = None) -> Any:
    """The parameter-level integration step: ``"none"`` returns ``params``,
    ``"model_avg"`` averages them. ``"ensemble"`` averages embeddings, not
    parameters, and is refused here (``gnn.train.apply_integration``)."""
    if kind not in INTEGRATION_KINDS:
        raise ValueError(f"integration kind must be one of "
                         f"{INTEGRATION_KINDS}, got {kind!r}")
    if kind == "ensemble":
        raise ValueError("ensemble integration is prediction-level; use "
                         "repro_torch.gnn.train.apply_integration with the "
                         "mode's forward")
    if kind == "none":
        return params
    return average_partition_params(params, weights)
