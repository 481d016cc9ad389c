"""The halo exchange of the sync and stale modes, on one device.

The reference runs one partition per device and refreshes every
partition's halo rows from their owners with an ``all_gather`` over the
padded ``[k, k, H_pad, F]`` send buffers, then a scatter (outside any
Pallas kernel); its gradient is the all-gather's transpose, a
reduce-scatter that sums what every receiver fed back into the rows that
were sent. Here the k partitions' activations are stacked ``[k, N_pad,
F]`` on one device, so the exchange is an index copy over the spec's live
``(peer, row)`` pairs only, the padding never materialized:

    out[p, recv_rows[p, q, j]] = h[q, send_rows[q, p, j]]

:func:`plan` flattens a :class:`~repro_torch.core.HaloExchangeSpec` once
into those pairs, as rows of the stacked ``[k·N_pad, F]`` view, on the
device. A partition's receiving rows are its halo rows and the sending
rows are owned rows, so the two sets are disjoint and every row is written
at most once (``recv_rows`` are unique within a partition).

:class:`ExchangeFn`'s backward is kernel A (:mod:`.csr_aggregate`) over the
exchange's own CSR: its rows are the stacked rows, every row that is not
overwritten carries an arc to itself, and every sending row an arc from
each slot it fed. One launch thus zeroes the overwritten rows' gradient
and adds, in a fixed order, the sums fed back to rows that were sent to
several partitions, with no atomics, so training stays bitwise
repeatable on the card. On the CPU it takes kernel A's plain version.

With one process per partition (:mod:`repro_torch.gnn.distributed`),
rank r's backward has the same shape: the gradient of its own rows, with
the rows it received zeroed, plus what every peer fed back into each row r
sent it. :func:`rank_plan` builds that CSR for one rank over its ``N_pad``
rows followed by the ``k·H_pad`` slots of the reduce-scatter's output
(its rows sum, in a fixed order, the slots a row was sent in), and
:func:`rank_backward_sum` runs kernel A over it. The arcs of each row come
in the order :func:`plan` gives them (the row itself, then the receiving
partitions in order), so a rank sums exactly what the stacked backward
sums for that partition, in the same order.

``calls`` counts exchanges (the trainers read it by epoch, either kind),
``launches`` the stacked backward's kernel A launches on the card and
``launches_rank`` the per-rank backward's (``ops.launch_counts``).
"""
from __future__ import annotations

from typing import TYPE_CHECKING, NamedTuple

import numpy as np
import torch

from . import csr_aggregate as _agg

if TYPE_CHECKING:
    from .ops import Csr

__all__ = ["ExchangePlan", "ExchangeFn", "plan", "exchange",
           "refresh_from", "backward_sum", "plain", "RankPlan", "rank_plan",
           "rank_backward_sum", "calls", "launches", "launches_rank"]

#: Exchanges (forward calls) made in this process.
calls = 0
#: Kernel A launches by the exchange's backward since the last reset.
launches = 0
#: Kernel A launches by a rank's backward (:func:`rank_backward_sum`).
launches_rank = 0


class ExchangePlan(NamedTuple):
    """The live pairs of a halo spec as rows of the stacked ``[k·N_pad, F]``
    view, and the CSR of the exchange's backward."""
    send: torch.Tensor        # [P] int64 stacked row of every live pair
    recv: torch.Tensor        # [P] int64 stacked row it overwrites
    received: torch.Tensor    # [k, N_pad, 1] bool, the overwritten rows
    csr: "Csr"                # over the k·N_pad rows (the backward)
    k: int
    n_pad: int

    @property
    def pairs(self) -> int:
        return int(self.send.shape[0])

    def exchange(self, h: torch.Tensor) -> torch.Tensor:
        return exchange(h, self)

    def refresh(self, h: torch.Tensor, cache: torch.Tensor) -> torch.Tensor:
        return refresh_from(h, cache, self)


def plan(halo, n_pad: int, device: torch.device) -> ExchangePlan:
    """Flatten ``halo`` (send_rows/recv_rows ``[k, k, H_pad]``, -1 pads)
    into stacked row pairs on ``device``, and build the backward's CSR."""
    from .ops import to_csr
    send_rows = np.asarray(halo.send_rows, dtype=np.int64)
    recv_rows = np.asarray(halo.recv_rows, dtype=np.int64)
    k = send_rows.shape[0]
    # pair (p receives from q, slot j): send_rows[q, p, j] lands in
    # recv_rows[p, q, j]
    p, q, j = np.nonzero(recv_rows >= 0)
    send = q * n_pad + send_rows[q, p, j]
    recv = p * n_pad + recv_rows[p, q, j]
    rows = k * n_pad
    if (send_rows[q, p, j] < 0).any() or \
            np.unique(recv).shape[0] != recv.shape[0]:
        raise ValueError("halo spec: a receiving slot has no sending row, or "
                         "a partition receives one row twice")
    received = np.zeros(rows, dtype=bool)
    received[recv] = True
    kept = np.nonzero(~received)[0]
    # backward arcs: kept rows from themselves, sending rows from the slots
    # they fed (to_csr sorts by row stably: the self arc comes first)
    arc_src = np.concatenate([kept, recv])
    arc_dst = np.concatenate([kept, send])
    csr = to_csr(torch.as_tensor(arc_src, device=device),
                 torch.as_tensor(arc_dst, device=device),
                 torch.ones(arc_src.shape[0], device=device), rows)
    return ExchangePlan(
        send=torch.as_tensor(send, device=device),
        recv=torch.as_tensor(recv, device=device),
        received=torch.as_tensor(received, device=device).reshape(k, n_pad,
                                                                  1),
        csr=csr, k=k, n_pad=int(n_pad))


def _check(h: torch.Tensor, pl: ExchangePlan) -> None:
    if h.dim() != 3 or tuple(h.shape[:2]) != (pl.k, pl.n_pad):
        raise ValueError(f"h must be [{pl.k}, {pl.n_pad}, F], got "
                         f"{tuple(h.shape)}")


def _copy(h: torch.Tensor, pl: ExchangePlan) -> torch.Tensor:
    flat = h.reshape(-1, h.shape[-1])
    out = flat.clone()
    out.index_copy_(0, pl.recv, flat.index_select(0, pl.send))
    return out.reshape(h.shape)


def backward_sum(g: torch.Tensor, pl: ExchangePlan) -> torch.Tensor:
    """The exchange's vector-Jacobian product: ``g`` with the overwritten
    rows zeroed, plus each sending row's fed-back sum (kernel A over
    ``pl.csr``; its plain version on the CPU)."""
    global launches
    flat = g.reshape(-1, g.shape[-1]).float().contiguous()
    csr = pl.csr
    if flat.device.type == "cuda":
        out = _agg.launch(flat, csr.src, csr.row_ptr, csr.weight)
        launches += 1
    else:
        out = _agg.plain(flat, csr.src, csr.dst, csr.weight, flat.shape[0])
    return out.reshape(g.shape).to(g.dtype)


class ExchangeFn(torch.autograd.Function):
    """The exchange (an index copy) with kernel A as its backward."""

    @staticmethod
    def forward(ctx, h, pl):
        ctx.pl = pl
        return _copy(h, pl)

    @staticmethod
    def backward(ctx, g):
        return backward_sum(g, ctx.pl), None


def exchange(h: torch.Tensor, pl: ExchangePlan) -> torch.Tensor:
    """Every partition's halo rows from their owners' rows of ``h``
    (``[k, N_pad, F]``, contiguous); differentiable in ``h``."""
    global calls
    _check(h, pl)
    calls += 1
    if torch.is_grad_enabled() and h.requires_grad:
        return ExchangeFn.apply(h, pl)
    return _copy(h, pl)


def refresh_from(h: torch.Tensor, cache: torch.Tensor,
                 pl: ExchangePlan) -> torch.Tensor:
    """The halo rows from ``cache`` (an earlier exchange's output), the
    rest from ``h``: stale mode's between-exchange refresh, no exchange
    and no gradient into ``cache``."""
    _check(h, pl)
    return torch.where(pl.received, cache, h)


def plain(h: torch.Tensor, pl: ExchangePlan) -> torch.Tensor:
    """The exchange as plain indexing, differentiated by autograd (its
    backward accumulates with ``index_put_``): the oracle of
    :class:`ExchangeFn`."""
    flat = h.reshape(-1, h.shape[-1])
    out = flat.index_put((pl.recv,), flat[pl.send])
    return out.reshape(h.shape)


class RankPlan(NamedTuple):
    """Rank ``rank``'s side of the exchange (one partition per rank): what
    it sends, where what it receives lands, and its backward's CSR."""
    send_idx: torch.Tensor     # [k·H_pad] int64 row sent in each slot (0
                               # on a padding slot)
    send_mask: torch.Tensor    # [k·H_pad, 1] f32, 0 on padding slots
    recv_slot: torch.Tensor    # [R] int64 slot (q·H_pad + j) of each row
                               # received
    recv_row: torch.Tensor     # [R] int64 the row it overwrites
    received: torch.Tensor     # [N_pad, 1] bool
    csr: "Csr"                 # over N_pad + k·H_pad rows; every arc
                               # ends in the first N_pad
    rank: int
    k: int
    h_pad: int
    n_pad: int


def rank_plan(halo, rank: int, n_pad: int, device: torch.device) -> RankPlan:
    """Rank ``rank``'s :class:`RankPlan` of ``halo`` (send_rows/recv_rows
    ``[k, k, H_pad]``, -1 pads) on ``device``."""
    from .ops import to_csr
    send_rows = np.asarray(halo.send_rows, dtype=np.int64)
    recv_rows = np.asarray(halo.recv_rows, dtype=np.int64)
    k, _, h_pad = send_rows.shape
    mine = send_rows[rank]                          # [k, H]: to peer c
    # rows I receive: from peer q, slot j, into recv_rows[rank, q, j]
    q, j = np.nonzero(recv_rows[rank] >= 0)
    recv_row = recv_rows[rank, q, j]
    if (send_rows[q, rank, j] < 0).any() or \
            np.unique(recv_row).shape[0] != recv_row.shape[0]:
        raise ValueError("halo spec: a receiving slot has no sending row, or "
                         "a partition receives one row twice")
    received = np.zeros(n_pad, dtype=bool)
    received[recv_row] = True
    kept = np.nonzero(~received)[0]
    # backward arcs: kept rows from themselves; each row I sent peer p in
    # slot j from the reduce-scatter's slot p·H + j, for the slots p reads
    p, jj = np.nonzero(recv_rows[:, rank, :] >= 0)
    arc_src = np.concatenate([kept, n_pad + p * h_pad + jj])
    arc_dst = np.concatenate([kept, mine[p, jj]])
    rows = n_pad + k * h_pad
    csr = to_csr(torch.as_tensor(arc_src, device=device),
                 torch.as_tensor(arc_dst, device=device),
                 torch.ones(arc_src.shape[0], device=device), rows)
    flat = mine.reshape(-1)
    return RankPlan(
        send_idx=torch.as_tensor(np.maximum(flat, 0), device=device),
        send_mask=torch.as_tensor((flat >= 0)[:, None], dtype=torch.float32,
                                  device=device),
        recv_slot=torch.as_tensor(q * h_pad + j, device=device),
        recv_row=torch.as_tensor(recv_row, device=device),
        received=torch.as_tensor(received[:, None], device=device),
        csr=csr, rank=int(rank), k=int(k), h_pad=int(h_pad),
        n_pad=int(n_pad))


def rank_backward_sum(g_and_slots: torch.Tensor, pl: RankPlan
                      ) -> torch.Tensor:
    """A rank's exchange backward: ``g_and_slots`` is ``[N_pad + k·H_pad,
    F]``, the gradient of the rank's refreshed rows followed by the
    reduce-scatter's fed-back slots; returns ``[N_pad, F]``: the rows the
    rank received zeroed, each row it sent plus its fed-back slots, in
    order (kernel A over ``pl.csr``; its plain version on the CPU)."""
    global launches_rank
    csr = pl.csr
    if g_and_slots.shape[0] != csr.num_nodes:
        raise ValueError(f"g_and_slots must be [{csr.num_nodes}, F], got "
                         f"{tuple(g_and_slots.shape)}")
    x = g_and_slots.float().contiguous()
    if x.device.type == "cuda":
        # every arc ends in the first N_pad rows: only they are written
        out = _agg.launch(x, csr.src, csr.row_ptr[:pl.n_pad + 1],
                          csr.weight, rows=pl.n_pad)
        launches_rank += 1
    else:
        out = _agg.plain(x, csr.src, csr.dst, csr.weight, pl.n_pad)
    return out
