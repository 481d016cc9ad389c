"""The port's kernels against the reference Pallas kernels.

On the CPU the port's dispatch (``repro_torch.kernels.ops``) runs each
kernel's plain PyTorch version; it is held against the reference's Pallas
kernels run in interpret mode through ``repro.kernels.ops`` with a forced
``KernelConfig``, at the reference's own tolerance (3e-5). The gradients
of the two ``autograd.Function``s (``dh``, ``dw``, ``dW``, ``db``; run on
the CPU through the port's own backward with the plain versions) are held
against ``jax.grad`` through the reference's custom VJPs in interpret mode,
and the plain edge dot against ``_edge_dot``, all at 3e-5. The tests marked
``cuda`` hold each CUDA kernel, forward and backward, against its plain
version on the card (3e-5) and skip where there is none.

Cases: N, F, E off every tile size; duplicate destinations; zero-degree
rows; unsorted destinations; weight-0 padding arcs parked at ``n_pad-1``
(the assembly's convention) and at row 0 (the reference's alignment
padding); skewed rows: a hub row of 3,000 live arcs, and a third of the
arcs as weight-0 padding parked at ``n-1`` with source 0, as the assembly
parks them; ``inv_scale`` given and absent; ``activate`` on and off; FO
not a multiple of 128.

The CUDA kernels split the work by merge path (``csrc/csr_rows.cuh``); a
numpy walk of the same split checks on the CPU that every arc is summed
once, in CSR order, by warps that walk at most ``2 * split(n, e).items``
items, and that the partial sums of cut rows add up to the plain result.
Kernel C walks the arcs in equal spans instead; a numpy walk of its spans
(``SPAN`` arcs a warp, ``BATCH`` at a time, ``PASS`` columns a pass, the
scaled g row reloaded only where ``dst`` changes) is held against
``edge_dot_ref`` at 3e-5 on spans that cross rows, empty rows, a hub row
across many spans, and F = 96 and 130.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import csr_aggregate as agg_kernel    # noqa: E402
from repro_torch.kernels import edge_dot as edge_kernel        # noqa: E402
from repro_torch.kernels import fused_layer as fused_kernel    # noqa: E402
from repro_torch.kernels import ops                            # noqa: E402
from repro_torch.kernels import ref as plain_ref               # noqa: E402

TOL = dict(rtol=3e-5, atol=3e-5)
CASES = ("sorted", "unsorted", "pad_last", "pad_row0", "hub", "pad_heavy")


def _graph(case, n=100, f=24, e=700, fo=50, seed=3):
    """Random arcs into the first half of the rows only (zero-degree rows,
    duplicate destinations), arranged per ``case``."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(n, f)).astype(np.float32)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n // 2, e)
    w = rng.random(e).astype(np.float32)
    if case == "hub":       # one live row with a few thousand arcs
        hub = 3000
        src = np.concatenate([src, rng.integers(0, n, hub)])
        dst = np.concatenate([dst, np.full(hub, 7)])
        w = np.concatenate([w, rng.uniform(0.1, 1.0, hub)
                            .astype(np.float32)])
    if case != "unsorted":
        dst = np.sort(dst)
    if case in ("pad_last", "pad_row0", "pad_heavy"):
        pad = e // 2 if case == "pad_heavy" else 37   # a third of E, or 37
        src = np.concatenate([src, np.zeros(pad, np.int64)])
        park = 0 if case == "pad_row0" else n - 1
        dst = np.concatenate([dst, np.full(pad, park)])
        w = np.concatenate([w, np.zeros(pad, np.float32)])
    deg = np.bincount(dst, weights=(w > 0), minlength=n).astype(np.float32)
    wmat = (rng.normal(size=(f, fo)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(fo,)) * 0.1).astype(np.float32)
    return h, src.astype(np.int32), dst.astype(np.int32), w, deg, wmat, b


def _t(x, device="cpu"):
    return torch.as_tensor(x).to(device)


@pytest.fixture
def ref():
    """The reference package's kernel entry points (JAX; the machine with
    the card runs only the ``cuda`` tests and may have no JAX)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as ref_ops
    from repro.kernels.autotune import KernelConfig
    return dict(
        jnp=jnp, ops=ref_ops,
        agg_cfg=KernelConfig(strategy="pallas", node_tile=64,
                             edge_block=128, feat_tile=128, stream=1),
        fused_cfg=KernelConfig(strategy="pallas_fused", node_tile=64,
                               edge_block=128, feat_tile=128, stream=1))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("with_inv", [True, False])
def test_csr_aggregate_plain_matches_pallas(ref, case, with_inv):
    jnp = ref["jnp"]
    h, src, dst, w, deg, _, _ = _graph(case)
    n = h.shape[0]
    inv = (1.0 / np.maximum(deg, 1.0)).astype(np.float32)
    expect = ref["ops"].csr_aggregate(
        jnp.asarray(h), jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w),
        num_nodes=n, inv_scale=jnp.asarray(inv) if with_inv else None,
        config=ref["agg_cfg"])
    csr = ops.to_csr(_t(src), _t(dst), _t(w), n)
    out = ops.csr_aggregate(_t(h), csr, _t(inv) if with_inv else None)
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), **TOL)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("activate", [True, False])
def test_fused_layer_plain_matches_pallas(ref, case, activate):
    jnp = ref["jnp"]
    h, src, dst, w, deg, wmat, b = _graph(case)
    expect = ref["ops"].fused_gcn_layer(
        jnp.asarray(h), jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w),
        jnp.asarray(deg), jnp.asarray(wmat), jnp.asarray(b),
        activate=activate, config=ref["fused_cfg"])
    csr = ops.to_csr(_t(src), _t(dst), _t(w), h.shape[0])
    out = ops.fused_gcn_layer(_t(h), csr, ops.inv_degree(_t(deg)),
                              _t(wmat), _t(b), activate=activate)
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), **TOL)


def test_to_csr_sorts_and_offsets_rows():
    h, src, dst, w, *_ = _graph("unsorted")
    csr = ops.to_csr(_t(src), _t(dst), _t(w), h.shape[0])
    d = csr.dst.numpy()
    assert (np.diff(d) >= 0).all()
    np.testing.assert_array_equal(
        csr.row_ptr.numpy(),
        np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=100))]))
    # a stable sort: arcs into one row keep their input order
    order = np.argsort(dst, kind="stable")
    np.testing.assert_array_equal(csr.src.numpy(), src[order])
    np.testing.assert_array_equal(csr.weight.numpy(), w[order])


def test_to_csr_builds_the_reversed_arcs():
    h, src, dst, w, *_ = _graph("unsorted")
    csr = ops.to_csr(_t(src), _t(dst), _t(w), h.shape[0])
    perm = csr.rev_perm.numpy()
    s_sorted = csr.src.numpy()[perm]
    assert (np.diff(s_sorted) >= 0).all()
    np.testing.assert_array_equal(perm, np.argsort(csr.src.numpy(),
                                                   kind="stable"))
    np.testing.assert_array_equal(csr.rev_src.numpy(), csr.dst.numpy()[perm])
    np.testing.assert_array_equal(csr.rev_dst.numpy(), s_sorted)
    np.testing.assert_array_equal(
        csr.rev_row_ptr.numpy(),
        np.concatenate([[0], np.cumsum(np.bincount(src, minlength=100))]))


def _grads(case, seed=11):
    """Inputs and a fixed random cotangent for the gradient tests."""
    h, src, dst, w, deg, wmat, b = _graph(case)
    rng = np.random.default_rng(seed)
    return h, src, dst, w, deg, wmat, b, rng


def _leaf(x):
    return _t(x).clone().requires_grad_()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("with_inv", [True, False])
def test_csr_aggregate_grads_match_pallas(ref, case, with_inv):
    """``dh`` and ``dw`` (in the caller's arc order, also for unsorted
    arcs) against ``jax.grad`` through ``_aggregate_diff``."""
    jax = pytest.importorskip("jax")
    jnp = ref["jnp"]
    h, src, dst, w, deg, _, _, rng = _grads(case)
    n = h.shape[0]
    inv = (1.0 / np.maximum(deg, 1.0)).astype(np.float32)
    g = rng.normal(size=h.shape).astype(np.float32)

    def loss(hh, ww):
        out = ref["ops"].csr_aggregate(
            hh, jnp.asarray(src), jnp.asarray(dst), ww, num_nodes=n,
            inv_scale=jnp.asarray(inv) if with_inv else None,
            config=ref["agg_cfg"])
        return jnp.sum(out * jnp.asarray(g))
    dh_ref, dw_ref = jax.grad(loss, argnums=(0, 1))(jnp.asarray(h),
                                                    jnp.asarray(w))
    ht, wt = _leaf(h), _leaf(w)
    csr = ops.to_csr(_t(src), _t(dst), wt, n)
    out = ops.csr_aggregate(ht, csr, _t(inv) if with_inv else None)
    dh, dw = torch.autograd.grad((out * _t(g)).sum(), (ht, wt))
    np.testing.assert_allclose(dh.numpy(), np.asarray(dh_ref), **TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_ref), **TOL)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("activate", [True, False])
def test_fused_layer_grads_match_pallas(ref, case, activate):
    """``dh``, ``dw``, ``dW`` and ``db`` against ``jax.grad`` through
    ``_fused_diff``."""
    jax = pytest.importorskip("jax")
    jnp = ref["jnp"]
    h, src, dst, w, deg, wmat, b, rng = _grads(case)
    g = rng.normal(size=(h.shape[0], wmat.shape[1])).astype(np.float32)

    def loss(hh, ww, wm, bb):
        out = ref["ops"].fused_gcn_layer(
            hh, jnp.asarray(src), jnp.asarray(dst), ww, jnp.asarray(deg),
            wm, bb, activate=activate, config=ref["fused_cfg"])
        return jnp.sum(out * jnp.asarray(g))
    expect = jax.grad(loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(wmat), jnp.asarray(b))
    leaves = [_leaf(x) for x in (h, w, wmat, b)]
    csr = ops.to_csr(_t(src), _t(dst), leaves[1], h.shape[0])
    out = ops.fused_gcn_layer(leaves[0], csr, ops.inv_degree(_t(deg)),
                              leaves[2], leaves[3], activate=activate)
    got = torch.autograd.grad((out * _t(g)).sum(), leaves)
    for name, a, e in zip(("dh", "dw", "dW", "db"), got, expect):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("with_inv", [True, False])
def test_edge_dot_plain_matches_pallas(ref, case, with_inv):
    """``edge_dot_ref`` against ``_edge_dot`` on the reference's own
    gathered operands (padded to whole edge blocks)."""
    from repro.kernels.csr_aggregate import _edge_dot
    jnp = ref["jnp"]
    h, src, dst, w, deg, _, _, rng = _grads(case)
    inv = (1.0 / np.maximum(deg, 1.0)).astype(np.float32) if with_inv \
        else np.ones(h.shape[0], np.float32)
    g = rng.normal(size=h.shape).astype(np.float32)
    e = src.shape[0]
    e_pad = -(-e // 128) * 128
    a = np.zeros((e_pad, h.shape[1]), np.float32)
    bb = np.zeros_like(a)
    a[:e], bb[:e] = h[src], (g * inv[:, None])[dst]
    expect = np.asarray(_edge_dot(jnp.asarray(a), jnp.asarray(bb),
                                  interpret=True,
                                  config=ref["agg_cfg"]))[:e]
    out = edge_kernel.edge_dot(_t(h), _t(g), _t(src), _t(dst),
                               _t(inv) if with_inv else None)
    np.testing.assert_allclose(out.numpy(), expect, **TOL)


def test_to_csr_rejects_out_of_range_arcs():
    with pytest.raises(ValueError, match="in \\[0, 4\\)"):
        ops.to_csr(_t(np.array([0, 4], np.int32)),
                   _t(np.array([0, 1], np.int32)),
                   _t(np.ones(2, np.float32)), 4)


def test_kernel_wrappers_refuse_cpu_tensors():
    h, src, dst, w, deg, wmat, b = _graph("sorted")
    csr = ops.to_csr(_t(src), _t(dst), _t(w), h.shape[0])
    with pytest.raises(ValueError, match="CUDA"):
        agg_kernel.launch(_t(h), csr.src, csr.row_ptr, csr.weight)
    with pytest.raises(ValueError, match="CUDA"):
        fused_kernel.launch(_t(h), csr.src, csr.row_ptr, csr.weight, None,
                            _t(wmat), _t(b))
    with pytest.raises(ValueError, match="CUDA"):
        edge_kernel.launch(_t(h), _t(h), csr.src, csr.dst)


def _merge_search(row_ptr, diag, n, e):
    """(rows ended, arcs consumed) at merged item ``diag``: what
    ``merge_search`` of ``csrc/csr_rows.cuh`` finds (by a 16-ary search
    there, by bisection here)."""
    lo, hi = max(diag - e, 0), min(diag, n)
    while lo < hi:
        mid = (lo + hi) >> 1
        if row_ptr[mid + 1] <= diag - mid - 1:
            lo = mid + 1
        else:
            hi = mid
    return lo, diag - lo


def _merge_path_walk(h, src, row_ptr, w, inv, sp):
    """The kernels' two passes in numpy (``gather_pass``, ``fixup_pass``).
    Returns the aggregate, the warps that summed each arc, and the items
    each warp walked."""
    n, f = h.shape
    e = src.shape[0]
    k = sp.items
    out = np.full((n, f), np.nan, np.float32)
    tail = np.full((sp.warps, f), np.nan, np.float32)
    head = tail.copy()
    head_row = np.full(sp.warps, -1)
    walked_by = [[] for _ in range(e)]
    walked = np.zeros(sp.warps, int)
    scale = np.ones(n, np.float32) if inv is None else inv

    def whole(r):           # ends within its first warp's range or the next
        return r + row_ptr[r + 1] < ((r + row_ptr[r]) // k + 2) * k

    for g in range(sp.warps):
        d0, d1 = g * k, min(g * k + k, n + e)
        i0, j0 = _merge_search(row_ptr, d0, n, e)
        i1, j1 = _merge_search(row_ptr, d1, n, e)
        assert (i1 - i0) + (j1 - j0) == d1 - d0 <= k
        r, j, head_r = i0, j0, -1
        if i0 < i1 and row_ptr[i0] < j0:
            if whole(i0):
                r, j = i0 + 1, row_ptr[i0 + 1]
            else:
                head_r = i0
        done, stop, open_tail = i1, j1, False
        if i1 < n and row_ptr[i1] < j1:
            if row_ptr[i1] >= j0 and whole(i1):
                done, stop = i1 + 1, row_ptr[i1 + 1]
            else:
                open_tail = True
        walked[g] = (done - r) + (stop - j)
        acc = np.zeros(f, np.float32)
        for a in range(j, stop):
            while r < done and row_ptr[r + 1] <= a:
                if r == head_r:
                    head[g] = acc
                else:
                    out[r] = acc * scale[r]
                acc, r = np.zeros(f, np.float32), r + 1
            acc = acc + w[a] * h[src[a]]
            walked_by[a].append(g)
        while r < done:
            if r == head_r:
                head[g] = acc
            else:
                out[r] = acc * scale[r]
            acc, r = np.zeros(f, np.float32), r + 1
        if open_tail:
            tail[g] = acc
        head_row[g] = head_r
    for g in np.flatnonzero(head_row >= 0):
        r = head_row[g]
        gs = (r + row_ptr[r]) // k
        out[r] = (tail[gs:g].sum(0) + head[g]) * scale[r]
    return out, walked_by, walked


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("with_inv", [True, False])
def test_merge_path_split_sums_every_arc_once(case, with_inv):
    """The kernels' work split: each warp's range is at most ``items``
    merged items and it walks at most twice that (a row that ends in the
    next range is walked whole by its first warp), every arc is summed by
    exactly one warp, warps take the arcs in CSR order, and the partial
    sums of cut rows give the plain result (3e-5)."""
    h, src, dst, w, deg, *_ = _graph(case)
    n = h.shape[0]
    inv = (1.0 / np.maximum(deg, 1.0)).astype(np.float32) if with_inv \
        else None
    csr = ops.to_csr(_t(src), _t(dst), _t(w), n)
    row_ptr, e = csr.row_ptr.numpy().astype(np.int64), src.shape[0]
    sp = agg_kernel.split(n, e)
    out, walked_by, walked = _merge_path_walk(h, csr.src.numpy(), row_ptr,
                                              csr.weight.numpy(), inv, sp)
    assert all(len(g) == 1 for g in walked_by)
    assert (np.diff([g[0] for g in walked_by]) >= 0).all()
    assert walked.max() <= 2 * sp.items
    assert max(np.diff(row_ptr)) > sp.items or case not in ("hub",
                                                             "pad_heavy")
    expect = agg_kernel.plain(_t(h), csr.src, csr.dst, csr.weight, n,
                              None if inv is None else _t(inv))
    np.testing.assert_allclose(out, expect.numpy(), **TOL)


@pytest.mark.parametrize("case", ["sorted", "hub", "pad_heavy"])
@pytest.mark.parametrize("items", [16, 32, 64, 128])
def test_merge_path_split_at_tuned_items(case, items):
    """The autotuner's ``items`` (``KernelConfig.items``) in place of the
    shape rule: the same invariants at every value the tuner sweeps, on a
    hub row and on a third of the arcs parked as padding in one row."""
    h, src, dst, w, deg, *_ = _graph(case)
    n = h.shape[0]
    inv = (1.0 / np.maximum(deg, 1.0)).astype(np.float32)
    csr = ops.to_csr(_t(src), _t(dst), _t(w), n)
    row_ptr, e = csr.row_ptr.numpy().astype(np.int64), src.shape[0]
    sp = agg_kernel.split(n, e, items)
    assert sp == (items, -(-(n + e) // items))
    out, walked_by, walked = _merge_path_walk(h, csr.src.numpy(), row_ptr,
                                              csr.weight.numpy(), inv, sp)
    assert all(len(g) == 1 for g in walked_by)
    assert (np.diff([g[0] for g in walked_by]) >= 0).all()
    assert walked.max() <= 2 * items
    expect = agg_kernel.plain(_t(h), csr.src, csr.dst, csr.weight, n,
                              _t(inv))
    np.testing.assert_allclose(out, expect.numpy(), **TOL)


def test_split_takes_the_tuned_items():
    assert agg_kernel.split(79344, 325288, 0) == \
        agg_kernel.split(79344, 325288) == (128, 3162)
    assert agg_kernel.split(79344, 325288, 16) == (16, 25290)
    for bad in (-1, agg_kernel.MAX_ITEMS + 1):
        with pytest.raises(ValueError, match="items"):
            agg_kernel.split(10, 10, bad)


def _edge_dot_span_walk(h, g, src, dst, inv):
    """Kernel C's walk in numpy: each warp takes ``SPAN`` consecutive arcs,
    ``PASS`` columns a pass (at least one), ``BATCH`` arcs at a time; it
    holds ``(inv * g)[dst]`` and loads it again only where ``dst`` changes
    (so every span loads its first row itself); each pass adds its 8
    partial dots into ``dw`` in pass order. Returns ``dw`` and the g rows
    each span loaded in its first pass."""
    e, f = src.shape[0], h.shape[1]
    span, batch, cols = edge_kernel.SPAN, edge_kernel.BATCH, edge_kernel.PASS
    scale = np.ones(h.shape[0], np.float32) if inv is None else inv
    out = np.full(e, np.nan, np.float32)
    loads = []
    for a0 in range(0, e, span):
        n_arcs = min(span, e - a0)
        first_pass_loads = 0
        for c0 in range(0, max(f, 1), cols):
            cur, gv = -1, None
            for j0 in range(0, n_arcs, batch):
                for a in range(j0, min(j0 + batch, n_arcs)):
                    d = dst[a0 + a]
                    if d != cur:
                        cur = d
                        gv = g[d, c0:c0 + cols] * scale[d]
                        first_pass_loads += c0 == 0
                    part = np.float32(np.dot(h[src[a0 + a], c0:c0 + cols],
                                             gv))
                    out[a0 + a] = part if c0 == 0 else out[a0 + a] + part
        loads.append(first_pass_loads)
    return out, loads


@pytest.mark.parametrize("case", ["sorted", "hub", "pad_heavy"])
@pytest.mark.parametrize("f", [96, 128, 130])
@pytest.mark.parametrize("with_inv", [True, False])
def test_edge_dot_span_walk_matches_plain(case, f, with_inv):
    """Kernel C's span walk against ``edge_dot_ref`` (3e-5 against the sum
    of absolute terms): spans cross row boundaries, rows in the upper half
    are empty, the hub row (3,000 arcs) and the padding row span many
    warps, and each span loads one g row per run of equal ``dst``."""
    h, src, dst, w, deg, _, _ = _graph(case, f=f)
    n = h.shape[0]
    g = np.random.default_rng(f).normal(size=(n, f)).astype(np.float32)
    inv = (1.0 / np.maximum(deg, 1.0)).astype(np.float32) if with_inv \
        else None
    csr = ops.to_csr(_t(src), _t(dst), _t(w), n)
    cs, cd = csr.src.numpy(), csr.dst.numpy()
    out, loads = _edge_dot_span_walk(h, g, cs, cd, inv)
    span = edge_kernel.SPAN
    runs = [1 + int((np.diff(cd[a:a + span]) != 0).sum())
            for a in range(0, cd.size, span)]
    assert loads == runs
    assert max(np.bincount(cd)) > 2 * span or case == "sorted"
    inv_t = None if inv is None else _t(inv)
    expect = edge_kernel.plain(_t(h), _t(g), csr.src, csr.dst, inv_t)
    abs_sum = edge_kernel.plain(_t(np.abs(h)), _t(np.abs(g)), csr.src,
                                csr.dst, inv_t)
    _assert_sum_close(_t(out), expect, abs_sum)


@pytest.mark.parametrize("n,e", [(1, 0), (33, 32), (264, 256),
                                 (79344, 325288), (10 ** 7, 10 ** 8)])
def test_split_bounds_the_items_per_warp(n, e):
    sp = agg_kernel.split(n, e)
    assert agg_kernel.MIN_ITEMS <= sp.items <= agg_kernel.MAX_ITEMS
    assert (sp.warps - 1) * sp.items < n + e <= sp.warps * sp.items
    if n + e >= agg_kernel.TARGET_WARPS * agg_kernel.MIN_ITEMS:
        assert sp.warps >= min(agg_kernel.TARGET_WARPS,
                               (n + e) // agg_kernel.MAX_ITEMS)


def _assert_sum_close(out, expect, abs_sum):
    """``|out - expect| <= 3e-5 + 3e-5 * abs_sum`` for a sum whose terms
    cancel, with ``abs_sum`` the same sum over absolute terms (the scale of
    its f32 rounding error), as ``chip_smoke.py`` holds the kernels."""
    assert torch.isfinite(out).all()
    bad = (out - expect).abs() > TOL["atol"] + TOL["rtol"] * abs_sum
    assert not bad.any(), (
        f"{int(bad.sum())} entries off; max abs err "
        f"{float((out - expect).abs().max()):.3e}")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", [(100, 24, 700, 50), (1000, 128, 9000, 128),
                                   (300, 200, 2000, 130)])
def test_cuda_kernels_match_plain(cuda, case, shape):
    n, f, e, fo = shape
    h, src, dst, w, deg, wmat, b = _graph(case, n, f, e, fo)
    csr = ops.to_csr(_t(src, cuda), _t(dst, cuda), _t(w, cuda), n)
    hc, inv = _t(h, cuda), ops.inv_degree(_t(deg, cuda))
    for scale in (inv, None):
        out = agg_kernel.launch(hc, csr.src, csr.row_ptr, csr.weight, scale)
        expect = agg_kernel.plain(hc, csr.src, csr.dst, csr.weight, n,
                                  scale)
        if case == "hub":
            # the hub row sums 3,000 terms of both signs: f32 rounding of
            # its partial sums in another order scales with their absolute
            # sum, not with the (cancelled) result
            _assert_sum_close(out, expect, agg_kernel.plain(
                hc.abs(), csr.src, csr.dst, csr.weight, n, scale))
            continue
        torch.testing.assert_close(out, expect, **TOL)
    for activate in (True, False):
        out, agg = fused_kernel.launch(hc, csr.src, csr.row_ptr, csr.weight,
                                       inv, _t(wmat, cuda), _t(b, cuda),
                                       activate=activate, need_agg=True)
        expect = fused_kernel.plain(hc, csr.src, csr.dst, csr.weight, inv,
                                    _t(wmat, cuda), _t(b, cuda),
                                    activate=activate)
        torch.testing.assert_close(out, expect, **TOL)
        torch.testing.assert_close(
            agg, agg_kernel.plain(hc, csr.src, csr.dst, csr.weight, n, inv),
            **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", [(100, 24, 700, 50), (1000, 128, 9000, 128),
                                   (300, 200, 2000, 130)])
def test_cuda_backward_matches_plain(cuda, case, shape):
    """Kernel C, and both Functions' gradients on the card, against the
    plain versions (autograd of the plain forward) on the same inputs."""
    n, f, e, fo = shape
    h, src, dst, w, deg, wmat, b = _graph(case, n, f, e, fo)
    g = torch.as_tensor(np.random.default_rng(12).normal(
        size=(n, fo)).astype(np.float32), device=cuda)
    inv = ops.inv_degree(_t(deg, cuda))
    csr = ops.to_csr(_t(src, cuda), _t(dst, cuda), _t(w, cuda), n)
    hc = _t(h, cuda)
    for scale in (inv, None):
        torch.testing.assert_close(
            edge_kernel.launch(hc, hc, csr.src, csr.dst, scale),
            edge_kernel.plain(hc, hc, csr.src, csr.dst, scale), **TOL)

    def leaves():
        return [_t(x, cuda).clone().requires_grad_() for x in (h, w, wmat, b)]
    for activate in (True, False):
        mine, plain = leaves(), leaves()
        out = ops.fused_gcn_layer(
            mine[0], ops.to_csr(_t(src, cuda), _t(dst, cuda), mine[1], n),
            inv, mine[2], mine[3], activate=activate)
        expect = plain_ref.fused_gcn_reference(
            plain[0], _t(src, cuda), _t(dst, cuda), plain[1], inv, plain[2],
            plain[3], activate=False)
        if activate:
            # the kernel's relu decisions: index_add_ on the card sums in no
            # fixed order, so a z next to 0 may round to either side there
            expect = expect * (out > 0).detach()
        torch.testing.assert_close(out, expect, **TOL)
        for a, e_ in zip(torch.autograd.grad((out * g).sum(), mine),
                         torch.autograd.grad((expect * g).sum(), plain)):
            torch.testing.assert_close(a, e_, **TOL)
    for scale in (inv, None):
        mine, plain = leaves()[:2], leaves()[:2]
        out = ops.csr_aggregate(
            mine[0], ops.to_csr(_t(src, cuda), _t(dst, cuda), mine[1], n),
            scale)
        expect = plain_ref.csr_aggregate_ref(plain[0], _t(src, cuda),
                                             _t(dst, cuda), plain[1], n,
                                             scale)
        gh = torch.as_tensor(np.random.default_rng(13).normal(
            size=(n, f)).astype(np.float32), device=cuda)
        for a, e_ in zip(torch.autograd.grad((out * gh).sum(), mine),
                         torch.autograd.grad((expect * gh).sum(), plain)):
            torch.testing.assert_close(a, e_, **TOL)


def _skewed(n=3000, f=128, fo=128, seed=5):
    """Rows around the merge-path split ``K = split(n, e).items``: a hub of
    several K arcs, rows of K-1, K and K+1 arcs, a third of the arcs as
    weight-0 padding parked at ``n-1`` with source 0, empty rows, and short
    random rows; arcs sorted by destination."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 6, n) * (rng.random(n) < 0.7)
    k = agg_kernel.MAX_ITEMS
    for _ in range(8):                    # K depends on E: settle it
        deg[[3, 11, 12, 13]] = (7 * k + 5, k - 1, k, k + 1)
        deg[n - 1] = 0
        live = int(deg.sum())
        deg[n - 1] = live // 2
        k_new = agg_kernel.split(n, int(deg.sum())).items
        if k_new == k:
            break
        k = k_new
    dst = np.repeat(np.arange(n), deg)
    e = dst.size
    src = rng.integers(0, n, e)
    w = rng.uniform(0.1, 1.0, e).astype(np.float32)
    pad = dst == n - 1
    src[pad], w[pad] = 0, 0.0
    h = rng.normal(size=(n, f)).astype(np.float32)
    wmat = (rng.normal(size=(f, fo)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(fo,)) * 0.1).astype(np.float32)
    in_deg = np.bincount(dst, weights=(w > 0), minlength=n).astype(np.float32)
    return h, src.astype(np.int32), dst.astype(np.int32), w, in_deg, wmat, b


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3000, 128, 128), (2000, 200, 130),
                                   (500, 24, 50)])
def test_cuda_skewed_rows_match_plain(cuda, shape):
    """Forward and backward of both kernels on rows longer than the split
    several times over, rows of exactly K and K+1 arcs and empty rows,
    against the plain versions at 3e-5, with and without ``inv``."""
    n, f, fo = shape
    h, src, dst, w, deg, wmat, b = _skewed(n, f, fo)
    sp = agg_kernel.split(n, src.size)
    assert np.bincount(dst, minlength=n).max() > 5 * sp.items
    inv = ops.inv_degree(_t(deg, cuda))
    csr = ops.to_csr(_t(src, cuda), _t(dst, cuda), _t(w, cuda), n)
    hc, wc, bc = _t(h, cuda), _t(wmat, cuda), _t(b, cuda)
    ha, wa, ba = hc.abs(), wc.abs(), bc.abs()
    for scale in (inv, None):
        expect_agg = agg_kernel.plain(hc, csr.src, csr.dst, csr.weight, n,
                                      scale)
        abs_agg = agg_kernel.plain(ha, csr.src, csr.dst, csr.weight, n,
                                   scale)
        _assert_sum_close(
            agg_kernel.launch(hc, csr.src, csr.row_ptr, csr.weight, scale),
            expect_agg, abs_agg)
        out, agg = fused_kernel.launch(hc, csr.src, csr.row_ptr, csr.weight,
                                       scale, wc, bc, activate=False,
                                       need_agg=True)
        _assert_sum_close(agg, expect_agg, abs_agg)
        _assert_sum_close(
            out, fused_kernel.plain(hc, csr.src, csr.dst, csr.weight, scale,
                                    wc, bc, activate=False),
            fused_kernel.plain(ha, csr.src, csr.dst, csr.weight, scale, wa,
                               ba, activate=False))
    g = torch.as_tensor(np.random.default_rng(6).normal(
        size=(n, fo)).astype(np.float32), device=cuda)

    def grads(x, wm, bb, cot, relu):
        """Gradients of <layer(x), cot> through the plain forward with the
        kernel forward's relu decisions."""
        leaves = [t.clone().requires_grad_() for t in (x, wm, bb)]
        z = plain_ref.fused_gcn_reference(leaves[0], csr.src, csr.dst,
                                          csr.weight, inv, leaves[1],
                                          leaves[2], activate=False)
        return torch.autograd.grad((z * relu * cot).sum(), leaves)
    mine = [t.clone().requires_grad_() for t in (hc, wc, bc)]
    out = ops.fused_gcn_layer(mine[0], csr, inv, mine[1], mine[2],
                              activate=True)
    relu = (out > 0).detach()
    for a, e_, s_ in zip(torch.autograd.grad((out * g).sum(), mine),
                         grads(hc, wc, bc, g, relu),
                         grads(ha, wa, ba, g.abs(), relu)):
        _assert_sum_close(a, e_, s_)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["sorted", "hub", "pad_heavy"])
@pytest.mark.parametrize("shape", [(100, 24, 700, 50), (1000, 128, 9000, 128),
                                   (300, 200, 2000, 130)])
def test_cuda_tuned_knobs_match_plain(cuda, case, shape):
    """The autotuner's knobs: kernel B at each row tile (32, 64, 128) is
    bitwise its 64-row result (k is summed in order whatever the tile),
    and kernel A at each ``items`` is held against the plain version, on
    ragged N, F and FO, a hub row and a padding row."""
    n, f, e, fo = shape
    h, src, dst, w, deg, wmat, b = _graph(case, n, f, e, fo)
    csr = ops.to_csr(_t(src, cuda), _t(dst, cuda), _t(w, cuda), n)
    hc, inv = _t(h, cuda), ops.inv_degree(_t(deg, cuda))
    wc, bc = _t(wmat, cuda), _t(b, cuda)
    expect_agg = agg_kernel.plain(hc, csr.src, csr.dst, csr.weight, n, inv)
    abs_agg = agg_kernel.plain(hc.abs(), csr.src, csr.dst, csr.weight, n,
                               inv)
    for items in (0, 16, 32, 64, 128):
        runs = [fused_kernel.launch(hc, csr.src, csr.row_ptr, csr.weight,
                                    inv, wc, bc, need_agg=True,
                                    node_tile=nt, items=items)
                for nt in fused_kernel.NODE_TILES]
        for out, agg in runs[1:]:
            assert torch.equal(out, runs[0][0]) and torch.equal(agg,
                                                                runs[0][1])
        _assert_sum_close(runs[0][1], expect_agg, abs_agg)
        _assert_sum_close(agg_kernel.launch(hc, csr.src, csr.row_ptr,
                                            csr.weight, inv, items),
                          expect_agg, abs_agg)
        z = plain_ref.gcn_epilogue(expect_agg, wc, bc, False)
        za = plain_ref.gcn_epilogue(abs_agg, wc.abs(), bc.abs(), False)
        out = runs[0][0]
        _assert_sum_close(out, z * (out > 0), za * (out > 0))
    with pytest.raises(ValueError, match="node_tile"):
        fused_kernel.launch(hc, csr.src, csr.row_ptr, csr.weight, inv, wc,
                            bc, node_tile=256)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(700, 512, 5000, 128),
                                   (300, 1000, 2000, 300),
                                   (130, 2048, 900, 7)])
def test_cuda_fused_layer_takes_wide_inputs(cuda, shape):
    """Kernel B's product walks F in chunks, so its shared memory does not
    grow with the input width: F up to 2,048 (and FO over several column
    tiles) against the plain version at 3e-5. One layer call counts once
    under kernel B and not under kernel A, whose kernel fills its
    aggregate."""
    n, f, e, fo = shape
    h, src, dst, w, deg, wmat, b = _graph("sorted", n, f, e, fo)
    csr = ops.to_csr(_t(src, cuda), _t(dst, cuda), _t(w, cuda), n)
    hc, inv = _t(h, cuda), ops.inv_degree(_t(deg, cuda))
    wc, bc = _t(wmat, cuda), _t(b, cuda)
    for activate in (True, False):
        ops.reset_launch_counts()
        out, agg = fused_kernel.launch(hc, csr.src, csr.row_ptr, csr.weight,
                                       inv, wc, bc, activate=activate,
                                       need_agg=True)
        counts = ops.launch_counts()
        assert (counts["fused_gcn_layer"], counts["csr_aggregate"]) == (1, 0)
        expect_agg = agg_kernel.plain(hc, csr.src, csr.dst, csr.weight, n,
                                      inv)
        torch.testing.assert_close(agg, expect_agg, **TOL)
        z = plain_ref.gcn_epilogue(expect_agg, wc, bc, False)
        za = plain_ref.gcn_epilogue(expect_agg.abs(), wc.abs(), bc.abs(),
                                    False)
        if activate:
            # the kernel's relu decisions, for a z that rounds next to 0
            z, za = z * (out > 0), za * (out > 0)
        _assert_sum_close(out, z, za)


@pytest.mark.cuda
def test_cuda_kernels_are_bitwise_deterministic(cuda):
    """Two calls of each kernel on skewed rows give bitwise-equal outputs:
    no atomics, partial sums added in a fixed order."""
    h, src, dst, w, deg, wmat, b = _skewed()
    n = h.shape[0]
    csr = ops.to_csr(_t(src, cuda), _t(dst, cuda), _t(w, cuda), n)
    hc, inv = _t(h, cuda), ops.inv_degree(_t(deg, cuda))
    rev_w = csr.weight.index_select(0, csr.rev_perm).contiguous()
    calls = {
        "A": lambda: agg_kernel.launch(hc, csr.src, csr.row_ptr, csr.weight,
                                       inv),
        "A transposed": lambda: agg_kernel.launch(hc, csr.rev_src,
                                                  csr.rev_row_ptr, rev_w),
        "B": lambda: torch.cat(fused_kernel.launch(
            hc, csr.src, csr.row_ptr, csr.weight, inv, _t(wmat, cuda),
            _t(b, cuda), need_agg=True), dim=1)}
    for name, call in calls.items():
        first, second = call(), call()
        assert torch.equal(first, second), name


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hub", "pad_heavy"])
@pytest.mark.parametrize("f", [24, 96, 128, 130, 300])
def test_cuda_edge_dot_widths(cuda, case, f):
    """Kernel C at feature widths off its float4 columns and its 128-wide
    pass, on rows that span many warps, against the plain version (3e-5
    against the sum of absolute terms), with and without ``inv``."""
    h, src, dst, w, deg, _, _ = _graph(case, f=f)
    n = h.shape[0]
    g = _t(np.random.default_rng(f).normal(size=(n, f)).astype(np.float32),
           cuda)
    csr = ops.to_csr(_t(src, cuda), _t(dst, cuda), _t(w, cuda), n)
    hc = _t(h, cuda)
    for inv in (ops.inv_degree(_t(deg, cuda)), None):
        out = edge_kernel.launch(hc, g, csr.src, csr.dst, inv)
        _assert_sum_close(out, edge_kernel.plain(hc, g, csr.src, csr.dst,
                                                 inv),
                          edge_kernel.plain(hc.abs(), g.abs(), csr.src,
                                            csr.dst, inv))


@pytest.mark.cuda
def test_cuda_edge_dot_is_bitwise_repeatable(cuda):
    """Two calls of kernel C on skewed rows give bitwise-equal outputs."""
    h, src, dst, w, deg, _, _ = _skewed()
    n = h.shape[0]
    csr = ops.to_csr(_t(src, cuda), _t(dst, cuda), _t(w, cuda), n)
    hc, inv = _t(h, cuda), ops.inv_degree(_t(deg, cuda))
    g = torch.randn(hc.shape, generator=torch.Generator(
        device=cuda).manual_seed(3), device=cuda)
    first = edge_kernel.launch(hc, g, csr.src, csr.dst, inv)
    assert torch.equal(first, edge_kernel.launch(hc, g, csr.src, csr.dst,
                                                 inv))
