"""Size-capped Leiden community detection (Traag, Waltman & van Eck 2019).

The paper (Definition 1) uses Leiden with a maximum community size
``S = beta * max_part_size``; communities maximize modularity

    Q = 1/(2m) * sum_c (e_c - gamma * K_c^2 / (2m))

subject to |C_i| <= S (size in original nodes, carried through aggregation
levels via ``Graph.node_weight``).

The three phases, iterated to a fixed point:
  1. local moving (frontier-batched, modularity-greedy, size-capped),
  2. refinement (each community re-split into connected sub-communities),
  3. aggregation (quotient graph on the refined partition, with the phase-1
     partition as the starting assignment at the next level).

Each local-move sweep scores every frontier node at once: neighbour labels
are gathered, connection weights segment-summed per ``(node, community)``
key, the best admissible move per node is picked, conflicts resolved (size
cap honoured cumulatively, A<->B swaps suppressed) and all surviving moves
applied in one shot. The port keeps the reference's draw order from the
seeded generator, so both packages return the same labels.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch import obs

from .engine import split_components
from .graph import Graph

# Sweeps stop when the frontier drains, when fewer than 1/_MOVE_CUTOFF of
# the nodes move, or when the budget runs out: small graphs get up to
# _MAX_SWEEPS, large graphs a handful (the next, smaller level finishes).
_MAX_SWEEPS = 100
_MIN_SWEEPS = 8
_SWEEP_ARC_BUDGET = 24_000_000
_MOVE_CUTOFF = 200
_GAIN_TOL = 1e-12
# Graphs with more arcs than this sweep their frontier in slices of at most
# this many arcs, which bounds the workspace and fixes the greedy order.
_BATCH_ARCS = 4_000_000


def _segment_starts(sorted_keys: np.ndarray) -> np.ndarray:
    """Indices where a new key group begins in a sorted key array."""
    return np.flatnonzero(np.r_[True, sorted_keys[1:] != sorted_keys[:-1]])


def _frontier_batches(g: Graph, nodes: np.ndarray, budget: int) -> list:
    """Split an ascending frontier into slices of at most ``budget`` arcs
    (a single over-budget node still gets a slice of its own)."""
    counts = g.indptr[nodes + 1] - g.indptr[nodes]
    csum = np.cumsum(counts)
    out = []
    start = 0
    while start < nodes.size:
        base = int(csum[start - 1]) if start else 0
        stop = int(np.searchsorted(csum, base + budget, side="right"))
        stop = max(stop, start + 1)
        out.append(nodes[start:stop])
        start = stop
    return out


def _local_move(g: Graph, labels: np.ndarray, comm_size: np.ndarray,
                comm_deg: np.ndarray, max_size: float, two_m: float,
                gamma: float, rng: np.random.Generator,
                fixed_community_of: Optional[np.ndarray] = None) -> bool:
    """Frontier-batched greedy local moving. Mutates labels/comm_size/
    comm_deg; returns True if anything moved.

    ``fixed_community_of``: when refining, node v may only join communities
    inside its phase-1 community. The gain of moving v from cv to c is

        delta(v -> c) = [w(v,c) - gamma*deg_v*K_c/(2m)] -
                        [w(v,cv\\v) - gamma*deg_v*(K_cv-deg_v)/(2m)]
    """
    n = g.n
    deg = g.degrees()
    node_w = g.node_weight
    S = comm_size.shape[0]              # community id capacity
    # seed-dependent node priority: the final tie-break in conflicts
    prio = rng.permutation(n)
    active = np.ones(n, dtype=bool)
    # the community each node last left: banning the direct return lets
    # period-2 oscillations of batched sweeps die out
    last_left = np.full(n, -1, dtype=np.int64)
    moved_any = False
    fixed = fixed_community_of
    sliced = g.num_arcs > _BATCH_ARCS
    max_sweeps = int(np.clip(_SWEEP_ARC_BUDGET // max(g.num_arcs, 1),
                             _MIN_SWEEPS, _MAX_SWEEPS))
    _empty = np.zeros(0, dtype=np.int64)

    def sweep_slice(nodes: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray, bool]:
        """Gather, score, resolve conflicts and apply the surviving moves
        of one frontier slice. Returns (accepted nodes, their targets,
        whether any positive-gain candidate existed)."""
        nonlocal comm_size, comm_deg
        asrc, adst, aw = g.gather_arcs(nodes)
        if asrc.size == 0:
            return _empty, _empty, False
        key = asrc * S + labels[adst]
        order = np.argsort(key, kind="stable")
        skey, sw = key[order], aw[order]
        starts = _segment_starts(skey)
        w_to = np.add.reduceat(sw, starts)
        ukey = skey[starts]
        unode = ukey // S
        ucomm = ukey % S
        cv = labels[unode]
        is_cur = ucomm == cv
        # gains against the slice-start community state
        w_v_cv = np.zeros(n)
        w_v_cv[unode[is_cur]] = w_to[is_cur]
        dv = deg[unode]
        base = w_v_cv[unode] - gamma * dv * (comm_deg[cv] - dv) / two_m
        gain = (w_to - gamma * dv * comm_deg[ucomm] / two_m) - base
        admissible = ~is_cur
        admissible &= comm_size[ucomm] + node_w[unode] <= max_size
        admissible &= ucomm != last_left[unode]
        if fixed is not None:
            admissible &= fixed[ucomm] == fixed[cv]
        gain = np.where(admissible, gain, -np.inf)
        # best admissible move per node, ties to the smaller community id
        nstart = _segment_starts(unode)
        group = np.repeat(np.arange(nstart.size), np.diff(np.r_[nstart,
                                                               unode.size]))
        gmax = np.maximum.reduceat(gain, nstart)
        winner = gain == gmax[group]
        pos = np.where(winner, np.arange(unode.size), unode.size)
        best = np.minimum.reduceat(pos, nstart)
        good = gmax > _GAIN_TOL
        best = best[good]
        mv_node, mv_to, mv_gain = unode[best], ucomm[best], gain[best]
        if mv_node.size == 0:
            return _empty, _empty, False
        mv_from = labels[mv_node]
        # swap guard: of pending A->B and B->A keep the move into the
        # smaller community id
        pair = mv_from * S + mv_to
        blocked = np.isin(mv_to * S + mv_from, pair) & (mv_to > mv_from)
        mv_node, mv_to, mv_from = (mv_node[~blocked], mv_to[~blocked],
                                   mv_from[~blocked])
        mv_gain = mv_gain[~blocked]
        if mv_node.size == 0:
            return _empty, _empty, False
        # cap-aware acceptance: per target, admit movers in gain order while
        # the cap holds against slice-start sizes (departures not credited)
        order2 = np.lexsort((prio[mv_node], -mv_gain, mv_to))
        t, nn, ff = mv_to[order2], mv_node[order2], mv_from[order2]
        w_add = node_w[nn]
        csum = np.cumsum(w_add)
        gstart = _segment_starts(t)
        glen = np.diff(np.r_[gstart, t.size])
        before_group = np.repeat(csum[gstart] - w_add[gstart], glen)
        accept = comm_size[t] + (csum - before_group) <= max_size
        nn, t, ff = nn[accept], t[accept], ff[accept]
        if nn.size == 0:
            return _empty, _empty, True
        labels[nn] = t
        last_left[nn] = ff
        dw, dd = node_w[nn], deg[nn]
        comm_size -= np.bincount(ff, weights=dw, minlength=S)
        comm_size += np.bincount(t, weights=dw, minlength=S)
        comm_deg -= np.bincount(ff, weights=dd, minlength=S)
        comm_deg += np.bincount(t, weights=dd, minlength=S)
        return nn, t, True

    sweeps_ctr = obs.counter("partition.sweeps")
    moves_ctr = obs.counter("partition.moves")
    for _ in range(max_sweeps):
        nodes = np.flatnonzero(active)
        if nodes.size == 0:
            break
        active[nodes] = False
        slices = (_frontier_batches(g, nodes, _BATCH_ARCS)
                  if sliced else [nodes])
        sweeps_ctr.inc()
        with obs.span("engine.sweep", frontier=int(nodes.size),
                      slices=len(slices)) as sweep_sp:
            moved_nodes, moved_to = [], []
            any_candidates = False
            for sl in slices:
                s_nn, s_t, had = sweep_slice(sl)
                any_candidates |= had
                if s_nn.size:
                    moved_nodes.append(s_nn)
                    moved_to.append(s_t)
            if not any_candidates:
                break
            if not moved_nodes:
                continue
            nn = np.concatenate(moved_nodes) if len(moved_nodes) > 1 \
                else moved_nodes[0]
            t = np.concatenate(moved_to) if len(moved_to) > 1 \
                else moved_to[0]
            moved_any = True
            moves_ctr.inc(int(nn.size))
            sweep_sp.set(moved=int(nn.size))
        if nn.size * _MOVE_CUTOFF < n:
            break
        # next frontier: neighbours of moved nodes that did not end up in
        # the mover's new community
        if sliced:
            order = np.argsort(nn, kind="stable")
            nn, t = nn[order], t[order]
            batches = _frontier_batches(g, nn, _BATCH_ARCS)
        else:
            batches = [nn]
        pos = 0
        for bn in batches:
            bt = t[pos:pos + bn.size]
            pos += bn.size
            _, mdst, _ = g.gather_arcs(bn)
            newlab = np.repeat(bt, g.indptr[bn + 1] - g.indptr[bn])
            active[mdst[labels[mdst] != newlab]] = True
    return moved_any


def _refine(g: Graph, labels: np.ndarray, max_size: float, two_m: float,
            gamma: float, rng: np.random.Generator) -> np.ndarray:
    """Refinement: from singletons, size-capped local moving restricted to
    the phase-1 communities, then split whatever is disconnected."""
    n = g.n
    ref = np.arange(n, dtype=np.int64)
    deg = g.degrees()
    comm_size = g.node_weight.copy()
    comm_deg = deg.copy()
    _local_move(g, ref, comm_size, comm_deg, max_size, two_m, gamma, rng,
                fixed_community_of=labels)
    return split_components(g, ref)


def leiden(g: Graph, max_community_size: Optional[float] = None,
           gamma: float = 1.0, seed: int = 0, max_levels: int = 10
           ) -> np.ndarray:
    """Size-capped Leiden; returns connected community labels (n,) int64.

    ``max_community_size`` is in original-graph nodes; ``None`` = uncapped.
    """
    if not gamma > 0:
        raise ValueError(f"gamma (resolution) must be > 0, got {gamma}")
    rng = np.random.default_rng(seed)
    two_m = 2.0 * g.m
    if two_m <= 0:
        return np.zeros(g.n, dtype=np.int64)
    cap = float(max_community_size) if max_community_size else np.inf

    level_graph = g
    node_to_level = np.arange(g.n, dtype=np.int64)
    init = np.arange(g.n, dtype=np.int64)
    final_labels = np.arange(g.n, dtype=np.int64)

    for lvl in range(max_levels):
        n = level_graph.n
        labels = init.copy()
        num_init = int(labels.max()) + 1
        comm_size = np.bincount(labels, weights=level_graph.node_weight,
                                minlength=num_init)
        comm_deg = np.bincount(labels, weights=level_graph.degrees(),
                               minlength=num_init)
        with obs.span("partition.local_move", level=lvl, n=int(n),
                      arcs=int(level_graph.num_arcs)):
            moved = _local_move(level_graph, labels, comm_size, comm_deg,
                                cap, two_m, gamma, rng)
        _, labels = np.unique(labels, return_inverse=True)
        num_comms = int(labels.max()) + 1
        final_labels = labels[node_to_level]
        if not moved or num_comms == n:
            break
        with obs.span("partition.refine", level=lvl, n=int(n)):
            refined = _refine(level_graph, labels, cap, two_m, gamma, rng)
        num_refined = int(refined.max()) + 1
        if num_refined == n:
            # aggregation would be the identity: the next level would
            # repeat this one
            break
        with obs.span("partition.aggregate", level=lvl, n=int(n),
                      communities=int(num_refined)):
            agg = level_graph.aggregate(refined)
        # the next level starts from the phase-1 partition, per Leiden
        ref_to_comm = np.zeros(num_refined, dtype=np.int64)
        ref_to_comm[refined] = labels
        init = ref_to_comm
        node_to_level = refined[node_to_level]
        level_graph = agg
    # connectivity on the final labels (a no-op when every level's
    # refinement held) and compact ids
    return split_components(g, final_labels)
