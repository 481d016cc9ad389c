"""The port's GNN inference against the reference package, with the
reference's parameters carried across by ``params_from_jax``.

Tolerances: 1e-5 for one layer, head or classifier (f32, sums taken in
another order); 1e-4 for the 3-layer stack, where those differences
compound through two relu layers.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp                                        # noqa: E402

from repro.core import build_partition_batch as ref_batch      # noqa: E402
from repro.core import make_arxiv_like as ref_arxiv            # noqa: E402
from repro.gnn import layers as ref_layers                     # noqa: E402
from repro.gnn import model as ref_model                       # noqa: E402
from repro.gnn import train as ref_train                       # noqa: E402
from repro_torch.core import (build_partition_batch,           # noqa: E402
                              make_arxiv_like, partition_from_spec)
from repro_torch.gnn import layers, model                      # noqa: E402
from repro_torch.gnn.infer import (compute_embeddings,         # noqa: E402
                                   gather_partition_tensors, params_from_jax,
                                   pool_embeddings)
from repro_torch.kernels import ops                            # noqa: E402

CPU = torch.device("cpu")
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
STACK_TOL = dict(rtol=1e-4, atol=1e-4)


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


def _arcs(seed=0, n=90, e=500):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = np.sort(rng.integers(0, n - 10, e)).astype(np.int32)
    w = rng.random(e).astype(np.float32)
    deg = np.bincount(dst, minlength=n).astype(np.float32)
    return src, dst, w, deg


@pytest.mark.parametrize("kind", ["gcn", "sage"])
@pytest.mark.parametrize("activate", [True, False])
def test_layer_matches_reference(kind, activate):
    n, f_in, f_out = 90, 24, 16
    src, dst, w, deg = _arcs()
    rng = np.random.default_rng(1)
    h = rng.normal(size=(n, f_in)).astype(np.float32)
    init = ref_layers.init_gcn_layer if kind == "gcn" \
        else ref_layers.init_sage_layer
    params = _to_np(init(jax.random.PRNGKey(2), f_in, f_out))
    params["b"] = rng.normal(size=(f_out,)).astype(np.float32)
    ref_fn = ref_layers.gcn_layer if kind == "gcn" else ref_layers.sage_layer
    expect = ref_fn(jax.tree.map(jnp.asarray, params), jnp.asarray(h),
                    jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w),
                    jnp.asarray(deg), activate=activate)
    fn = layers.gcn_layer if kind == "gcn" else layers.sage_layer
    csr = ops.to_csr(torch.as_tensor(src), torch.as_tensor(dst),
                     torch.as_tensor(w), n)
    out = fn(params_from_jax(params, CPU), torch.as_tensor(h), csr,
             torch.as_tensor(deg), activate=activate)
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), **LAYER_TOL)


def test_aggregate_mean_matches_reference():
    n = 90
    src, dst, w, deg = _arcs(seed=4)
    h = np.random.default_rng(5).normal(size=(n, 20)).astype(np.float32)
    expect = ref_layers.aggregate_mean(jnp.asarray(h), jnp.asarray(src),
                                       jnp.asarray(dst), jnp.asarray(w),
                                       jnp.asarray(deg))
    csr = ops.to_csr(torch.as_tensor(src), torch.as_tensor(dst),
                     torch.as_tensor(w), n)
    out = layers.aggregate_mean(torch.as_tensor(h), csr,
                                torch.as_tensor(deg))
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), **LAYER_TOL)


def test_head_and_classifier_match_reference():
    rng = np.random.default_rng(6)
    emb = rng.normal(size=(40, 16)).astype(np.float32)
    head = {"w": rng.normal(size=(16, 5)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32)}
    clf = _to_np(ref_model.init_mlp(jax.random.PRNGKey(7), 16, 32, 5))
    np.testing.assert_allclose(
        model.head_logits(params_from_jax(head, CPU),
                          torch.as_tensor(emb)).numpy(),
        np.asarray(ref_model.head_logits(jax.tree.map(jnp.asarray, head),
                                         jnp.asarray(emb))), **LAYER_TOL)
    np.testing.assert_allclose(
        model.mlp_forward(params_from_jax(clf, CPU),
                          torch.as_tensor(emb)).numpy(),
        np.asarray(ref_model.mlp_forward(jax.tree.map(jnp.asarray, clf),
                                         jnp.asarray(emb))), **LAYER_TOL)


@pytest.fixture(scope="module")
def graphs():
    mine, ref = make_arxiv_like(n=600, feature_dim=32), \
        ref_arxiv(n=600, feature_dim=32)
    labels = partition_from_spec(mine.graph, "leiden_fusion", 2).labels
    return (mine, build_partition_batch(mine.graph, labels, "repli"),
            ref, ref_batch(ref.graph, labels, "repli"))


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_partition_embeddings_match_reference(graphs, kind):
    ds, batch, ref_ds, rbatch = graphs
    cfg_kw = dict(kind=kind, feature_dim=32, hidden_dim=32, embed_dim=16,
                  num_layers=3)
    ref_cfg = ref_model.GNNConfig(**cfg_kw)
    params = ref_train.init_partition_models(jax.random.PRNGKey(0), ref_cfg,
                                             ds.num_classes, batch.k)
    pt = ref_train.gather_partition_tensors(ref_ds, rbatch)
    tensors = {name: jnp.asarray(getattr(pt, name)) for name in
               ("features", "edge_src", "edge_dst", "edge_weight",
                "in_degree", "node_mask")}
    expect = np.asarray(ref_train.compute_embeddings(params, ref_cfg,
                                                     tensors))

    mine = gather_partition_tensors(ds, batch, CPU)
    emb = compute_embeddings(params_from_jax(_to_np(params), CPU),
                             model.GNNConfig(**cfg_kw), mine)
    assert emb.shape == expect.shape == (batch.k, batch.n_pad, 16)
    np.testing.assert_allclose(emb.numpy(), expect, **STACK_TOL)

    pooled = pool_embeddings(emb, mine, ds.graph.n)
    np.testing.assert_allclose(
        pooled.numpy(),
        ref_train.pool_embeddings(expect, pt, ds.graph.n, 16), **STACK_TOL)


def test_params_from_jax_keeps_the_stacked_layout():
    cfg = ref_model.GNNConfig(kind="gcn", feature_dim=8, hidden_dim=6,
                              embed_dim=4, num_layers=2)
    params = _to_np(ref_train.init_partition_models(jax.random.PRNGKey(1),
                                                    cfg, 3, 5))
    mine = params_from_jax(params, CPU)
    assert [tuple(lp["w"].shape) for lp in mine["body"]["layers"]] == \
        [(5, 8, 6), (5, 6, 4)]
    assert tuple(mine["head"]["w"].shape) == (5, 4, 3)
    assert tuple(mine["head"]["b"].shape) == (5, 3)
    np.testing.assert_array_equal(mine["body"]["layers"][1]["w"].numpy(),
                                  params["body"]["layers"][1]["w"])
