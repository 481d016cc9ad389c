"""The port's local training against the reference package.

Inputs come from numpy with a seed; the reference's initial parameters are
carried across with ``params_from_jax``; the reference runs on the CPU with
``mesh=None`` semantics (its jitted single-device step, driven here).

Tolerances:
* AdamW, one step or twenty, stacked or not: 1e-6 (f32 elementwise math;
  only the global norm's sum runs in another order);
* losses: 1e-6 (one f32 reduction);
* training parity at ``dropout=0``: per-epoch loss 1e-4 and the pooled
  table 1e-3 (ROADMAP A.4): sums run in another order, the differences
  compound through three layers and every AdamW step;
* vmapped against sequential (both the port's): 1e-6, the reference's pin;
* parameter averaging 1e-6; integrated embeddings 1e-4 (a 3-layer stack);
* the classifier's accuracies: equal, from the same initial MLP.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp                                        # noqa: E402

from repro.core import assemble as ref_assemble                # noqa: E402
from repro.core import build_partition_batch as ref_batch      # noqa: E402
from repro.gnn import model as ref_model                       # noqa: E402
from repro.gnn import train as ref_train                       # noqa: E402
from repro.optim import adamw as ref_adamw                     # noqa: E402
from repro.pipeline import datasets as ref_datasets            # noqa: E402
from repro_torch.core import (average_partition_params,        # noqa: E402
                              build_partition_batch, integrate_models,
                              partition_from_spec)
from repro_torch.gnn import model                              # noqa: E402
from repro_torch.gnn.infer import (compute_embeddings,         # noqa: E402
                                   gather_partition_tensors, params_from_jax)
from repro_torch.gnn.train import (apply_integration,          # noqa: E402
                                   mean_rocauc, train_classifier,
                                   train_local)
from repro_torch.kernels import ops                            # noqa: E402
from repro_torch.optim import adamw_init, adamw_update         # noqa: E402
from repro_torch.pipeline.datasets import get_dataset          # noqa: E402
from repro_torch.pipeline.pipeline import (PipelineConfig,     # noqa: E402
                                           PipelineReport, run_training)
from repro_torch.serving.store import EmbeddingStore, classify  # noqa: E402

CPU = torch.device("cpu")
OPT_TOL = dict(rtol=1e-6, atol=1e-6)
LOSS_TOL = dict(rtol=1e-4, atol=1e-4)
TABLE_TOL = dict(rtol=1e-3, atol=1e-3)
STACK_TOL = dict(rtol=1e-4, atol=1e-4)
DIMS = dict(hidden_dim=16, embed_dim=16, num_layers=3)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return params_from_jax(_np(tree), CPU)


def _close(mine, ref, tol):
    """Assert two trees (port tensors, reference arrays) agree leafwise."""
    ref_leaves = jax.tree.leaves(_np(ref))
    mine_leaves = jax.tree.leaves(jax.tree.map(
        lambda x: x.detach().numpy(), mine,
        is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert len(ref_leaves) == len(mine_leaves)
    for a, b in zip(mine_leaves, ref_leaves):
        np.testing.assert_allclose(a, b, **tol)


def _tree(rng, k=None):
    lead = () if k is None else (k,)
    return {"body": {"layers": [
        {"w": rng.normal(size=lead + (6, 5)).astype(np.float32),
         "b": rng.normal(size=lead + (5,)).astype(np.float32)},
        {"w": rng.normal(size=lead + (5, 3)).astype(np.float32),
         "b": rng.normal(size=lead + (3,)).astype(np.float32)}]},
        "head": {"w": rng.normal(size=lead + (3, 2)).astype(np.float32),
                 "b": rng.normal(size=lead + (2,)).astype(np.float32)}}


# -- AdamW -----------------------------------------------------------------
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adamw_matches_reference_for_20_steps(weight_decay):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    ref_p, ref_s = params, ref_adamw.adamw_init(params)
    mine_p = _t(params)
    mine_s = adamw_init(mine_p)
    clipped = 0
    for step in range(20):
        # steps 0, 5, 10, 15 carry norms far above clip_norm=1
        scale = 30.0 if step % 5 == 0 else 0.05
        grads = jax.tree.map(
            lambda x: (rng.normal(size=x.shape) * scale).astype(np.float32),
            params)
        gnorm = np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                            for g in jax.tree.leaves(grads)))
        clipped += gnorm > 1.0
        ref_p, ref_s = ref_adamw.adamw_update(grads, ref_s, ref_p, 5e-3,
                                              weight_decay=weight_decay)
        mine_p, mine_s = adamw_update(_t(grads), mine_s, mine_p, 5e-3,
                                      weight_decay=weight_decay)
        _close(mine_p, ref_p, OPT_TOL)
    assert 0 < clipped < 20
    _close(mine_s.mu, ref_s.mu, OPT_TOL)
    _close(mine_s.nu, ref_s.nu, OPT_TOL)
    assert int(mine_s.step) == int(ref_s.step) == 20


def test_adamw_clips_each_partition_by_its_own_norm():
    """A stacked k = 3 tree matches three independent reference calls; the
    partitions' gradient norms straddle the clip."""
    rng = np.random.default_rng(1)
    k = 3
    params = _tree(rng, k)
    mine_p = _t(params)
    mine_s = adamw_init(mine_p, stacked=True)
    refs = [(jax.tree.map(lambda x: x[p], params),
             ref_adamw.adamw_init(jax.tree.map(lambda x: x[p], params)))
            for p in range(k)]
    for step in range(5):
        grads = jax.tree.map(lambda x: rng.normal(size=x.shape)
                             .astype(np.float32), params)
        for leaf in jax.tree.leaves(grads):
            leaf[0] *= 40.0          # clipped
            leaf[1] *= 0.01          # not clipped
        mine_p, mine_s = adamw_update(_t(grads), mine_s, mine_p, 1e-2)
        refs = [ref_adamw.adamw_update(jax.tree.map(lambda x: x[p], grads),
                                       s, rp, 1e-2)
                for p, (rp, s) in enumerate(refs)]
    assert mine_s.step.tolist() == [5, 5, 5]
    for p, (rp, _) in enumerate(refs):
        _close(jax.tree.map(lambda x: x[p], mine_p,
                            is_leaf=lambda x: isinstance(x, torch.Tensor)),
               rp, OPT_TOL)


# -- losses and dropout ----------------------------------------------------
@pytest.mark.parametrize("empty_mask", [False, True])
def test_losses_match_reference(empty_mask):
    rng = np.random.default_rng(2)
    logits = (rng.normal(size=(50, 7)) * 3).astype(np.float32)
    labels = rng.integers(0, 7, 50).astype(np.int32)
    targets = (rng.random((50, 7)) > 0.6).astype(np.float32)
    mask = (rng.random(50) > 0.4).astype(np.float32) * (not empty_mask)
    np.testing.assert_allclose(
        model.softmax_xent(torch.as_tensor(logits), torch.as_tensor(labels),
                           torch.as_tensor(mask)).numpy(),
        np.asarray(ref_model.softmax_xent(jnp.asarray(logits),
                                          jnp.asarray(labels),
                                          jnp.asarray(mask))), **OPT_TOL)
    np.testing.assert_allclose(
        model.sigmoid_bce(torch.as_tensor(logits), torch.as_tensor(targets),
                          torch.as_tensor(mask)).numpy(),
        np.asarray(ref_model.sigmoid_bce(jnp.asarray(logits),
                                         jnp.asarray(targets),
                                         jnp.asarray(mask))), **OPT_TOL)


def test_dropout_keeps_a_binomial_fraction_scaled_up():
    p, shape = 0.3, (400, 50)
    out = model.dropout(torch.ones(shape), p,
                        torch.Generator().manual_seed(3))
    kept = out != 0
    torch.testing.assert_close(out[kept], torch.full_like(out[kept],
                                                          1 / (1 - p)))
    n = shape[0] * shape[1]
    sigma = np.sqrt(n * p * (1 - p))
    assert abs(int(kept.sum()) - n * (1 - p)) < 5 * sigma


def _small_gnn(num_layers):
    rng = np.random.default_rng(4)
    n, f = 60, 12
    src = rng.integers(0, n, 300).astype(np.int32)
    dst = np.sort(rng.integers(0, n, 300)).astype(np.int32)
    csr = ops.to_csr(torch.as_tensor(src), torch.as_tensor(dst),
                     torch.ones(300), n)
    deg = torch.as_tensor(np.bincount(dst, minlength=n).astype(np.float32))
    cfg = model.GNNConfig(feature_dim=f, hidden_dim=10, embed_dim=8,
                          num_layers=num_layers, dropout=0.5)
    dims = cfg.dims
    params = {"layers": [
        {"w": torch.as_tensor(rng.normal(size=(a, b)).astype(np.float32)),
         "b": torch.full((b,), 0.1)} for a, b in zip(dims[:-1], dims[1:])]}
    h = torch.as_tensor(rng.normal(size=(n, f)).astype(np.float32))
    return lambda gen: model.gnn_forward(params, cfg, h, csr, deg,
                                         dropout_gen=gen)


def test_dropout_skips_the_last_layer_and_repeats_per_generator():
    one_layer = _small_gnn(1)
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state()
    torch.testing.assert_close(one_layer(gen), one_layer(None), rtol=0,
                               atol=0)
    assert torch.equal(gen.get_state(), state)      # nothing was drawn
    two = _small_gnn(2)
    a = two(torch.Generator().manual_seed(6))
    b = two(torch.Generator().manual_seed(6))
    c = two(torch.Generator().manual_seed(7))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert not torch.equal(a, two(None))


# -- training against the reference ---------------------------------------
GRAPHS = {"karate": ({}, 60), "arxiv-like": ({"n": 400, "feature_dim": 32},
                                             20)}


def _reference_training(name, kind, lr=1e-2):
    """The reference's jitted vmapped step from its initial parameters,
    with every epoch's losses, and its pooled table."""
    kwargs, epochs = GRAPHS[name]
    ref_ds = ref_datasets.get_dataset(name, **kwargs)
    ds = get_dataset(name, **kwargs)
    labels = partition_from_spec(ds.graph, "leiden_fusion", 4).labels
    rbatch = ref_batch(ref_ds.graph, labels, scheme="repli")
    cfg_kw = dict(kind=kind, feature_dim=int(ds.features.shape[1]),
                  dropout=0.0, **DIMS)
    ref_cfg = ref_model.GNNConfig(**cfg_kw)
    params0 = _np(ref_train.init_partition_models(
        jax.random.PRNGKey(0), ref_cfg, ds.num_classes, 4))
    pt = ref_train.gather_partition_tensors(ref_ds, rbatch)
    tensors = {key: jnp.asarray(getattr(pt, key)) for key in
               ("features", "labels", "train_mask", "edge_src", "edge_dst",
                "edge_weight", "in_degree", "node_mask")}
    step = jax.jit(ref_train.make_local_train_step(ref_cfg, False, lr))
    params = jax.tree.map(jnp.asarray, params0)
    opt = jax.vmap(ref_adamw.adamw_init)(params)
    keys = jax.random.split(jax.random.PRNGKey(1), 4)
    losses = []
    for _ in range(epochs):
        params, opt, loss = step(params, opt, tensors, keys)
        losses.append(np.asarray(loss))
    emb = np.asarray(ref_train.compute_embeddings(params, ref_cfg, tensors))
    table = ref_train.pool_embeddings(emb, pt, ds.graph.n, 16)
    return dict(ds=ds, batch=build_partition_batch(ds.graph, labels, "repli"),
                cfg=model.GNNConfig(**cfg_kw), params0=params0,
                params=_np(params), losses=np.stack(losses), table=table,
                epochs=epochs, lr=lr)


@pytest.mark.parametrize("kind", ["gcn", "sage"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_local_training_matches_reference(name, kind):
    ref = _reference_training(name, kind)
    out = train_local(ref["ds"], ref["batch"], ref["cfg"],
                      epochs=ref["epochs"], lr=ref["lr"], device="cpu",
                      params=_t(ref["params0"]))
    assert out.losses.shape == ref["losses"].shape == (ref["epochs"], 4)
    np.testing.assert_allclose(out.losses, ref["losses"], **LOSS_TOL)
    assert out.losses[-1].mean() < out.losses[0].mean()
    np.testing.assert_allclose(out.embeddings.numpy(), ref["table"],
                               **TABLE_TOL)


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_vmapped_and_sequential_training_agree(kind):
    """With dropout on: per-partition generators make both loop orders draw
    the same masks."""
    ds = get_dataset("arxiv-like", n=400, feature_dim=32)
    labels = partition_from_spec(ds.graph, "leiden_fusion", 3).labels
    batch = build_partition_batch(ds.graph, labels, "repli")
    cfg = model.GNNConfig(kind=kind, feature_dim=32, dropout=0.3, **DIMS)
    runs = [train_local(ds, batch, cfg, epochs=6, lr=1e-2, seed=3,
                        device="cpu", sequential=seq) for seq in (False,
                                                                  True)]
    _close(runs[1].params, jax.tree.map(
        lambda x: x.numpy(), runs[0].params,
        is_leaf=lambda x: isinstance(x, torch.Tensor)), OPT_TOL)
    np.testing.assert_allclose(runs[1].losses, runs[0].losses, **OPT_TOL)
    np.testing.assert_allclose(runs[1].embeddings.numpy(),
                               runs[0].embeddings.numpy(), **OPT_TOL)
    plain = train_local(ds, batch, dataclasses.replace(cfg, dropout=0.0),
                        epochs=6, lr=1e-2, seed=3, device="cpu")
    assert not np.allclose(plain.losses, runs[0].losses)   # dropout ran


# -- model integration -----------------------------------------------------
@pytest.mark.parametrize("weights", [None, [1.0, 3.0, 0.5, 2.0]])
def test_average_partition_params_matches_reference(weights):
    params = _tree(np.random.default_rng(8), 4)
    w = None if weights is None else np.asarray(weights, np.float32)
    _close(average_partition_params(_t(params), w),
           ref_assemble.average_partition_params(
               jax.tree.map(jnp.asarray, params), w), OPT_TOL)
    _close(integrate_models(_t(params), "none"), params, OPT_TOL)
    with pytest.raises(ValueError, match="prediction-level"):
        integrate_models(_t(params), "ensemble")


@pytest.mark.parametrize("kind", ["none", "model_avg", "ensemble"])
def test_apply_integration_matches_reference(kind):
    ds = get_dataset("arxiv-like", n=300, feature_dim=32)
    ref_ds = ref_datasets.get_dataset("arxiv-like", n=300, feature_dim=32)
    labels = partition_from_spec(ds.graph, "leiden_fusion", 3).labels
    ref_cfg = ref_model.GNNConfig(kind="gcn", feature_dim=32, **DIMS)
    params = _np(ref_train.init_partition_models(
        jax.random.PRNGKey(2), ref_cfg, ds.num_classes, 3))
    pt = ref_train.gather_partition_tensors(
        ref_ds, ref_batch(ref_ds.graph, labels, "repli"))
    tensors = {key: jnp.asarray(getattr(pt, key)) for key in
               ("features", "edge_src", "edge_dst", "edge_weight",
                "in_degree", "node_mask")}
    ref_params, ref_emb = ref_train.apply_integration(
        jax.tree.map(jnp.asarray, params), kind,
        lambda p: ref_train.compute_embeddings(p, ref_cfg, tensors), 3)
    mine = gather_partition_tensors(
        ds, build_partition_batch(ds.graph, labels, "repli"), CPU)
    cfg = model.GNNConfig(kind="gcn", feature_dim=32, **DIMS)
    my_params, my_emb = apply_integration(
        _t(params), kind, lambda p: compute_embeddings(p, cfg, mine), 3)
    _close(my_params, ref_params, OPT_TOL)
    np.testing.assert_allclose(my_emb.numpy(), np.asarray(ref_emb),
                               **STACK_TOL)


# -- classifier --------------------------------------------------------------
def test_train_classifier_matches_reference():
    ds = get_dataset("arxiv-like", n=500, feature_dim=32)
    ref_ds = ref_datasets.get_dataset("arxiv-like", n=500, feature_dim=32)
    emb = np.random.default_rng(9).normal(size=(500, 16)).astype(np.float32)
    emb += np.eye(40, 16, dtype=np.float32)[ds.labels] * 2.0
    ref_acc, ref_params = ref_train.train_classifier(
        ref_ds, emb, hidden=32, epochs=40, seed=5, return_params=True)
    init = _np(ref_model.init_mlp(jax.random.PRNGKey(5), 16, 32, 40))
    acc, params = train_classifier(ds, torch.as_tensor(emb), hidden=32,
                                   epochs=40, params=_t(init))
    assert acc == ref_acc
    assert ref_acc["train"] > 0.5
    _close(params, ref_params, dict(rtol=1e-4, atol=1e-4))


def test_mean_rocauc_matches_reference():
    rng = np.random.default_rng(10)
    y = (rng.random((200, 5)) > 0.7).astype(np.float32)
    y[:, 4] = 0.0                                  # a task with no positives
    score = np.round(rng.normal(size=(200, 5)) + y, 1)   # ties
    assert mean_rocauc(y, score) == ref_train.mean_rocauc(y, score)


# -- the pipeline ----------------------------------------------------------
def test_run_training_exports_the_trained_bundle(tmp_path):
    cfg = PipelineConfig(dataset="karate", k=4, epochs=20,
                         classifier_epochs=30, classifier_hidden=32,
                         serving_dir=str(tmp_path), **DIMS)
    result = run_training(cfg, device="cpu")
    report = PipelineReport.of(cfg, result)
    assert set(report.accuracy) == {"train", "val", "test"}
    assert {"dataset", "partition", "assemble", "to_device", "train",
            "classifier", "classify", "export"} <= set(report.timings)
    assert report.shapes["k"] == 4 and report.num_nodes == 34
    assert "accuracy" in report.summary()
    assert result.losses.shape == (20, 4)
    np.testing.assert_array_equal(
        result.predictions,
        classify(result.classifier, result.embeddings).argmax(-1).numpy())
    store = EmbeddingStore.load(result.serving_path, device="cpu")
    np.testing.assert_array_equal(store.predictions, result.predictions)
    torch.testing.assert_close(store.classifier["w1"],
                               result.classifier["w1"])
