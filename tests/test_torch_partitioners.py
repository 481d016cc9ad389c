"""The port's partitioner layer against the reference package: labels,
spec strings, fingerprints, partition reports, the Proteins-like dataset,
the artifact cache and serving bundles across packages, and multilabel
training.

Tolerances: labels, fingerprints, canonical specs, reports, datasets and
cached arrays are exactly equal (the same numpy code on the same inputs).
Multilabel training parity holds the per-epoch losses at 1e-4 and the
pooled table at 1e-3 (abs + rel), as ``tests/test_torch_train.py`` does:
sums run in another order and the differences compound through every
AdamW step.
"""
import dataclasses
import json

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp                                        # noqa: E402

from repro import core as ref_core                             # noqa: E402
from repro.gnn import model as ref_model                       # noqa: E402
from repro.gnn import train as ref_train                       # noqa: E402
from repro.optim import adamw as ref_adamw                     # noqa: E402
from repro.pipeline import artifacts as ref_artifacts          # noqa: E402
from repro.pipeline import datasets as ref_datasets            # noqa: E402
from repro.pipeline import pipeline as ref_pipeline            # noqa: E402
from repro.serving import store as ref_store                   # noqa: E402
from repro_torch import core                                   # noqa: E402
from repro_torch.gnn import model                              # noqa: E402
from repro_torch.gnn.infer import params_from_jax              # noqa: E402
from repro_torch.gnn.train import train_local                  # noqa: E402
from repro_torch.pipeline import artifacts, cli                # noqa: E402
from repro_torch.pipeline.datasets import (get_dataset,        # noqa: E402
                                           graph_fingerprint)
from repro_torch.pipeline.pipeline import (PipelineConfig,     # noqa: E402
                                           PipelineReport, run_inference,
                                           run_training)
from repro_torch.serving.store import EmbeddingStore           # noqa: E402

CPU = torch.device("cpu")
METHODS = ("random", "single", "lpa", "metis", "leiden_fusion", "lpa+f",
           "metis+f")
GRAPHS = {"karate": {}, "arxiv2000": {"n": 2000}}
DATASET_FIELDS = ("features", "labels", "train_mask", "val_mask",
                  "test_mask")
GRAPH_FIELDS = ("indptr", "indices", "edge_weight", "node_weight",
                "self_weight")
# the reference's own spec examples (tests/test_partitioner_api.py, the
# spec module's docstring)
SPEC_EXAMPLES = (
    "metis", "lpa(max_iter=30,balance_cap=1.5)",
    "  Leiden-Fusion ( resolution = 0.5 ) ", "LPA + F", "metis+f",
    "lpa(max_iter=20)+f(alpha=0.1,base_k=32)", "leiden_fusion(resolution=2)",
    "metis_f", "lpa_f", "lpa(max_iter=50)", "lpa(balance_cap=1.5,max_iter=50)",
    "metis+f(alpha=0.05)", "lpa(balance_cap=2.0,max_iter=9)",
    "metis(coarsen_to=400)", "lpa(balance_cap=1.1)", "lpa(max_iter=10)",
    "lpa+f(alpha=0.1)", "lpa + f ( alpha = 0.1 )", "leiden_fusion",
    "random", "single", "leiden_fusion(alpha=0.1,beta=0.3)")
BAD_SPECS = ("", "lpa(", "lpa)", "lpa(max_iter)", "lpa(max_iter=1;2)",
             "lpa+g", "nope", "lpa(gamma=2)", "lpa+f(beta=0.5)",
             "lpa(max_iter=1,max_iter=2)", "lpa(max_iter=1.5)",
             "lpa(balance_cap=big)", "lpa(balance_cap=0.5)",
             "leiden_fusion(resolution=0)", "metis+f(alpha=-0.1)",
             "metis_f(alpha=0.1)")


def _graphs(name):
    if name == "karate":
        return (get_dataset("karate").graph,
                ref_datasets.get_dataset("karate").graph)
    return (core.make_arxiv_like(**GRAPHS[name]).graph,
            ref_core.make_arxiv_like(**GRAPHS[name]).graph)


@pytest.fixture(scope="module")
def graphs():
    return {name: _graphs(name) for name in GRAPHS}


def _run(fn):
    """(labels, None) or (None, the exception's type)."""
    try:
        return fn(), None
    except Exception as e:                       # noqa: BLE001
        return None, type(e)


@pytest.fixture(scope="module")
def labels_of(graphs):
    """``(name, method, k) -> ((port labels, error), (reference labels,
    error))``, each pair computed once per module."""
    memo = {}

    def labels(name, method, k):
        if (name, method, k) not in memo:
            g, rg = graphs[name]
            memo[name, method, k] = (
                _run(lambda: core.partition_from_spec(g, method, k).labels),
                _run(lambda: ref_core.partition_from_spec(
                    rg, method, k).labels))
        return memo[name, method, k]
    return labels


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_labels_are_byte_identical(labels_of, name, method, k):
    (mine, err), (ref, ref_err) = labels_of(name, method, k)
    assert err is ref_err
    if ref is not None:
        assert mine.dtype == ref.dtype == np.int64
        assert np.array_equal(mine, ref)


@pytest.mark.parametrize("k", [0, -1])
@pytest.mark.parametrize("method", ["metis", "lpa+f"])
def test_bad_k_raises_as_the_reference_does(labels_of, method, k):
    (mine, err), (ref, ref_err) = labels_of("karate", method, k)
    assert ref is None and mine is None
    assert err is ref_err is ValueError


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_partition_reports_equal(graphs, labels_of, name, method):
    (mine, _), (ref, _) = labels_of(name, method, 4)
    g, rg = graphs[name]
    got = core.evaluate_partition(g, mine)
    expect = ref_core.evaluate_partition(rg, ref)
    assert got.as_dict() == expect.as_dict()
    assert dataclasses.asdict(got) == dataclasses.asdict(expect)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_fusion_connects_every_part(graphs, labels_of, name):
    """+f and Leiden-Fusion: one component per part on a connected graph
    (the paper's guarantee; capability flag ``connectivity``)."""
    g, _ = graphs[name]
    for method in ("leiden_fusion", "lpa+f", "metis+f"):
        assert core.PartitionerSpec.parse(
            method).capabilities.connectivity_guaranteed
        (labels, _), _ = labels_of(name, method, 4)
        assert core.evaluate_partition(g, labels).max_components == 1


@pytest.mark.parametrize("text", SPEC_EXAMPLES)
def test_spec_canonical_and_fingerprint_equal(text):
    mine, ref = core.PartitionerSpec.parse(text), \
        ref_core.PartitionerSpec.parse(text)
    assert mine.canonical() == ref.canonical()
    assert mine.fingerprint() == ref.fingerprint()
    assert dataclasses.asdict(mine.config) == dataclasses.asdict(ref.config)
    assert mine.capabilities.describe() == ref.capabilities.describe()


@pytest.mark.parametrize("text", BAD_SPECS)
def test_bad_specs_raise_as_the_reference_does(text):
    _, err = _run(lambda: core.PartitionerSpec.parse(text))
    _, ref_err = _run(lambda: ref_core.PartitionerSpec.parse(text))
    assert ref_err is not None and err is ref_err


@st.composite
def spec_texts(draw):
    """A well-formed spec over the built-in registry, odd spacing
    included."""
    method = METHODS[draw(st.integers(0, len(METHODS) - 3))]
    fields = []
    if method == "lpa":
        if draw(st.integers(0, 1)):
            fields.append(f"max_iter={draw(st.integers(1, 99))}")
        if draw(st.integers(0, 1)):
            fields.append(f"balance_cap={1.0 + draw(st.integers(0, 300)) / 100}")
    elif method == "metis":
        if draw(st.integers(0, 1)):
            fields.append(f"coarsen_to={draw(st.integers(1, 2000))}")
    elif method == "leiden_fusion":
        if draw(st.integers(0, 1)):
            fields.append(f"alpha={draw(st.integers(0, 100)) / 100}")
        if draw(st.integers(0, 1)):
            fields.append(f"beta={(draw(st.integers(0, 99)) + 1) / 100}")
        if draw(st.integers(0, 1)):
            fields.append(f"resolution={(draw(st.integers(0, 400)) + 1) / 100}")
    pad = " " * draw(st.integers(0, 2))
    text = method + (f"({pad}{f',{pad}'.join(fields)}{pad})" if fields
                     else "")
    if draw(st.integers(0, 1)):
        ffields = []
        if draw(st.integers(0, 1)):
            ffields.append(f"alpha={draw(st.integers(0, 100)) / 100}")
        if draw(st.integers(0, 1)):
            ffields.append(f"base_k={draw(st.integers(1, 64))}")
        text += f"{pad}+f" + (f"({','.join(ffields)})" if ffields else "")
    return text


@settings(database=None, derandomize=True, max_examples=60, deadline=None)
@given(text=spec_texts())
def test_property_spec_round_trip_matches_reference(text):
    mine = core.PartitionerSpec.parse(text)
    ref = ref_core.PartitionerSpec.parse(text)
    canon = mine.canonical()
    assert canon == ref.canonical()
    assert mine.fingerprint() == ref.fingerprint()
    again = core.PartitionerSpec.parse(canon)
    assert again == mine and again.canonical() == canon
    assert again.fingerprint() == ref_core.PartitionerSpec.parse(
        canon).fingerprint()


def test_registry_matches_reference():
    mine, ref = core.registered_partitioners(), \
        ref_core.registered_partitioners()
    assert list(mine) == list(ref)
    for name in mine:
        a, b = mine[name], ref[name]
        assert a.capabilities.describe() == b.capabilities.describe()
        assert a.doc == b.doc
        assert ([(f.name, f.default) for f in
                 dataclasses.fields(a.config_type)]
                == [(f.name, f.default) for f in
                    dataclasses.fields(b.config_type)])
    result = mine["metis"].partition(_graphs("karate")[0], 4, seed=3)
    assert result.spec == "metis" and result.k == 4 and result.seed == 3


@pytest.mark.parametrize("kwargs", [{"n": 300}, {}])
def test_proteins_like_is_byte_identical(kwargs):
    mine = get_dataset("proteins", **kwargs)
    ref = ref_datasets.get_dataset("proteins", **kwargs)
    assert mine.graph.n == ref.graph.n
    for field in GRAPH_FIELDS:
        a, b = getattr(mine.graph, field), getattr(ref.graph, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    for field in DATASET_FIELDS:
        a, b = getattr(mine, field), getattr(ref, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert (mine.num_classes, mine.multilabel, mine.name) == \
        (ref.num_classes, ref.multilabel, ref.name) == \
        (112, True, "proteins_like")
    assert graph_fingerprint(mine.graph) == \
        ref_datasets.graph_fingerprint(ref.graph)


@pytest.mark.parametrize("spec", ["metis+f", "leiden_fusion(resolution=0.5)"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_cache_entries_hit_across_packages(graphs, tmp_path, writer, spec):
    """Either package's entry is a hit in the other; the reference's batch
    bundle carries its halo arrays, which the port loads."""
    g, rg = graphs["arxiv2000"]
    mine = artifacts.PartitionArtifactStore(str(tmp_path))
    theirs = ref_artifacts.PartitionArtifactStore(str(tmp_path))
    if writer == "port":
        first = mine.load_or_compute(g, spec, 4, 0, "repli")
        second = theirs.load_or_compute(rg, spec, 4, 0, "repli")
    else:
        first = theirs.load_or_compute(rg, spec, 4, 0, "repli",
                                       with_halo=True)
        second = mine.load_or_compute(g, spec, 4, 0, "repli")
    assert not (first.labels_hit or first.batch_hit)
    assert second.labels_hit and second.batch_hit
    assert (first.labels_path, first.batch_path) == \
        (second.labels_path, second.batch_path)
    assert first.fingerprint == second.fingerprint
    assert (second.halo is not None) == (writer == "reference")
    assert np.array_equal(first.labels, second.labels)
    for field in artifacts._BATCH_FIELDS + ("n_pad", "e_pad"):
        a = np.asarray(getattr(first.batch, field))
        b = np.asarray(getattr(second.batch, field))
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert len(mine.entries()) == 2 and mine.clear() == 2


def test_serving_bundle_for_metis_f_loads_across_packages(tmp_path):
    spec = "metis+f"
    dims = dict(k=4, hidden_dim=16, embed_dim=16, classifier_hidden=32)
    port = run_inference(PipelineConfig(
        dataset="karate", method=spec, serving_dir=str(tmp_path / "port"),
        **dims), device="cpu")
    ref_fp = ref_core.PartitionerSpec.parse(spec).fingerprint()
    graph_fp = graph_fingerprint(port.dataset.graph)
    theirs = ref_store.EmbeddingStore.load(
        port.serving_path, expect_fingerprint=ref_fp, expect_graph=graph_fp)
    np.testing.assert_array_equal(theirs.lookup(np.arange(34)),
                                  port.embeddings.numpy())
    assert theirs.meta["spec"] == spec
    ref_report = ref_pipeline.Pipeline(ref_pipeline.PipelineConfig(
        dataset="karate", method=spec, epochs=2, classifier_epochs=2,
        shard_data_axis=False, collect_hlo=False,
        serving_dir=str(tmp_path / "ref"), **dims)).run()
    mine = EmbeddingStore.load(
        ref_report.serving_path, device="cpu",
        expect_fingerprint=port.spec.fingerprint(), expect_graph=graph_fp)
    assert port.spec.fingerprint() == ref_fp == \
        ref_report.partition_fingerprint
    assert mine.k == 4 and mine.n == 34
    np.testing.assert_array_equal(mine.partition_of, port.labels)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_multilabel_training_matches_reference(kind):
    """proteins-like, n 300, 12 tasks, k 4, dropout 0, 20 epochs: the
    reference's jitted vmapped step (``mesh=None`` semantics) from its
    initial parameters, against ``train_local`` from the same."""
    kwargs, k, epochs, lr = {"n": 300, "num_tasks": 12}, 4, 20, 1e-2
    ds = get_dataset("proteins", **kwargs)
    ref_ds = ref_datasets.get_dataset("proteins", **kwargs)
    labels = core.partition_from_spec(ds.graph, "leiden_fusion", k).labels
    rbatch = ref_core.build_partition_batch(ref_ds.graph, labels, "repli")
    cfg_kw = dict(kind=kind, feature_dim=8, hidden_dim=16, embed_dim=16,
                  num_layers=3, dropout=0.0)
    ref_cfg = ref_model.GNNConfig(**cfg_kw)
    params0 = _np(ref_train.init_partition_models(
        jax.random.PRNGKey(0), ref_cfg, ds.num_classes, k))
    pt = ref_train.gather_partition_tensors(ref_ds, rbatch)
    tensors = {key: jnp.asarray(getattr(pt, key)) for key in
               ("features", "labels", "train_mask", "edge_src", "edge_dst",
                "edge_weight", "in_degree", "node_mask")}
    step = jax.jit(ref_train.make_local_train_step(ref_cfg, True, lr))
    params = jax.tree.map(jnp.asarray, params0)
    opt = jax.vmap(ref_adamw.adamw_init)(params)
    keys = jax.random.split(jax.random.PRNGKey(1), k)
    ref_losses = []
    for _ in range(epochs):
        params, opt, loss = step(params, opt, tensors, keys)
        ref_losses.append(np.asarray(loss))
    ref_table = ref_train.pool_embeddings(
        np.asarray(ref_train.compute_embeddings(params, ref_cfg, tensors)),
        pt, ds.graph.n, 16)

    out = train_local(ds, core.build_partition_batch(ds.graph, labels,
                                                     "repli"),
                      model.GNNConfig(**cfg_kw), epochs=epochs, lr=lr,
                      device="cpu", params=params_from_jax(params0, CPU))
    np.testing.assert_allclose(out.losses, np.stack(ref_losses),
                               rtol=1e-4, atol=1e-4)
    assert out.losses[-1].mean() < out.losses[0].mean()
    np.testing.assert_allclose(out.embeddings.numpy(), ref_table,
                               rtol=1e-3, atol=1e-3)


def test_pipeline_reports_partition_metrics_and_cache_hits(tmp_path):
    cfg = PipelineConfig(dataset="karate", method="lpa+f", k=4, epochs=2,
                         classifier_epochs=2, hidden_dim=8, embed_dim=8,
                         classifier_hidden=8, cache_dir=str(tmp_path))
    first = PipelineReport.of(cfg, run_training(cfg, device="cpu"))
    again = run_training(cfg, device="cpu")
    second = PipelineReport.of(cfg, again)
    g = again.dataset.graph
    expect = ref_core.evaluate_partition(
        ref_datasets.get_dataset("karate").graph,
        ref_core.partition_from_spec(
            ref_datasets.get_dataset("karate").graph, "lpa+f", 4).labels)
    assert first.partition == second.partition == expect.as_dict()
    assert not (first.partition_cache_hit or first.batch_cache_hit)
    assert second.partition_cache_hit and second.batch_cache_hit
    assert second.config["method"] == "lpa+f"
    assert second.partition_fingerprint == \
        ref_core.PartitionerSpec.parse("lpa+f").fingerprint()
    assert "[cache HIT]" in second.summary()
    assert "isolated=" in second.summary()
    assert again.timings["partition"] == 0.0
    assert np.array_equal(again.labels, core.partition_from_spec(
        g, "lpa+f", 4).labels)
    with pytest.raises(ValueError, match="unknown partitioner"):
        run_training(dataclasses.replace(cfg, method="nope"), device="cpu")


def test_cli_partitioners_and_cache(tmp_path, capsys):
    assert cli.main(["partitioners", "--json"]) == 0
    listing = json.loads(capsys.readouterr().out)
    assert set(listing) == set(METHODS[:5]) | {"+f"}
    assert listing["metis"]["fields"]["coarsen_to"]["default"] == 400
    assert cli.main(["partitioners"]) == 0
    assert "spec grammar" in capsys.readouterr().out
    store = artifacts.PartitionArtifactStore(str(tmp_path))
    store.load_or_compute(_graphs("karate")[0], "metis+f", 4, 0, "inner")
    assert cli.main(["cache", "--cache-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "labels-metis+f-k4-s0-" in out and "(2 artifacts)" in out
    assert cli.main(["cache", "--cache-dir", str(tmp_path), "--clear"]) == 0
    assert "removed 2" in capsys.readouterr().out
    assert store.entries() == []
