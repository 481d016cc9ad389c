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
padding); ``inv_scale`` given and absent; ``activate`` on and off; FO not
a multiple of 128.
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
CASES = ("sorted", "unsorted", "pad_last", "pad_row0")


def _graph(case, n=100, f=24, e=700, fo=50, seed=3):
    """Random arcs into the first half of the rows only (zero-degree rows,
    duplicate destinations), arranged per ``case``."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(n, f)).astype(np.float32)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n // 2, e)
    w = rng.random(e).astype(np.float32)
    if case != "unsorted":
        dst = np.sort(dst)
    if case in ("pad_last", "pad_row0"):
        pad = 37
        src = np.concatenate([src, np.zeros(pad, np.int64)])
        park = n - 1 if case == "pad_last" else 0
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
