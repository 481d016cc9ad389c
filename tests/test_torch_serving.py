"""The port's serving path against the reference package, on karate and a
small arxiv-like graph with the reference's parameters carried across.

Pins: the pooled table (1e-4: a 3-layer f32 stack) and the offline answer
key (exact); serving bundles load across packages (exact arrays, equal
fingerprints); the batcher answers every known node exactly as the key
says; the inductive aggregation and logits match the reference's plain
path (1e-5); a zero-neighbour query degrades instead of crashing.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp                                        # noqa: E402

from repro.core import PartitionerSpec                         # noqa: E402
from repro.core import build_partition_batch as ref_batch      # noqa: E402
from repro.gnn import model as ref_model                       # noqa: E402
from repro.gnn import train as ref_train                       # noqa: E402
from repro.pipeline import datasets as ref_datasets            # noqa: E402
from repro.serving import inductive as ref_inductive           # noqa: E402
from repro.serving import store as ref_store                   # noqa: E402
from repro_torch.gnn.infer import params_from_jax              # noqa: E402
from repro_torch.pipeline.datasets import (get_dataset,        # noqa: E402
                                           graph_fingerprint)
from repro_torch.pipeline.pipeline import (PipelineConfig,     # noqa: E402
                                           run_inference)
from repro_torch.serving.batcher import ContinuousBatcher      # noqa: E402
from repro_torch.serving.inductive import (aggregate_and_head,  # noqa: E402
                                           route_neighbors)
from repro_torch.serving.replay import (make_zipf_workload,    # noqa: E402
                                        run_replay)
from repro_torch.serving.store import EmbeddingStore           # noqa: E402

CPU = torch.device("cpu")
K = 4
DIMS = dict(hidden_dim=16, embed_dim=16, num_layers=3)
GRAPHS = {"karate": {}, "arxiv-like": {"n": 400, "feature_dim": 32}}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def served(request, tmp_path_factory):
    """One port inference run per graph with carried reference parameters,
    and the reference's own table and answer key for the same inputs."""
    name = request.param
    tmp = tmp_path_factory.mktemp("srv")
    ds = get_dataset(name, **GRAPHS[name])
    ref_ds = ref_datasets.get_dataset(name, **GRAPHS[name])
    spec = PartitionerSpec.parse("leiden_fusion")
    labels = spec.partition(ref_ds.graph, K, seed=0).labels
    rbatch = ref_batch(ref_ds.graph, labels, scheme="repli")
    ref_cfg = ref_model.GNNConfig(
        kind="gcn", feature_dim=int(ref_ds.features.shape[1]), **DIMS)
    params = ref_train.init_partition_models(jax.random.PRNGKey(0), ref_cfg,
                                             ref_ds.num_classes, K)
    clf = ref_model.init_mlp(jax.random.PRNGKey(1), 16, 32,
                             ref_ds.num_classes)
    pt = ref_train.gather_partition_tensors(ref_ds, rbatch)
    tensors = {k: jnp.asarray(getattr(pt, k)) for k in
               ("features", "edge_src", "edge_dst", "edge_weight",
                "in_degree", "node_mask")}
    ref_table = ref_train.pool_embeddings(
        np.asarray(ref_train.compute_embeddings(params, ref_cfg, tensors)),
        pt, ref_ds.graph.n, 16)
    ref_key = np.asarray(ref_model.mlp_forward(
        clf, jnp.asarray(ref_table))).argmax(-1)

    cfg = PipelineConfig(dataset=name, k=K, classifier_hidden=32,
                         serving_dir=str(tmp / "port"), **DIMS)
    result = run_inference(cfg, device="cpu", ds=ds,
                           params=params_from_jax(_np(params), CPU),
                           classifier=params_from_jax(_np(clf), CPU))
    ref_path = ref_store.export_serving_bundle(
        str(tmp / "ref"), part_labels=labels, embeddings=ref_table,
        predictions=ref_key, head_w=np.asarray(params["head"]["w"]),
        head_b=np.asarray(params["head"]["b"]),
        classifier=_np(clf),
        meta={"partition_fingerprint": spec.fingerprint(),
              "spec": spec.canonical(),
              "graph": ref_datasets.graph_fingerprint(ref_ds.graph),
              "dataset": ref_ds.name, "n": ref_ds.graph.n, "k": K,
              "num_classes": ref_ds.num_classes, "embed_dim": 16})
    return dict(ds=ds, result=result, labels=labels, ref_table=ref_table,
                ref_key=ref_key, ref_path=ref_path, spec=spec, cfg=cfg,
                ref_graph_fp=ref_datasets.graph_fingerprint(ref_ds.graph))


def test_pooled_table_and_answer_key_match_reference(served):
    result = served["result"]
    np.testing.assert_array_equal(result.labels, served["labels"])
    np.testing.assert_allclose(result.embeddings.numpy(),
                               served["ref_table"], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(result.predictions, served["ref_key"])


def test_bundles_load_across_packages(served):
    result, spec = served["result"], served["spec"]
    # the port's bundle in the reference's store
    theirs = ref_store.EmbeddingStore.load(
        result.serving_path, expect_fingerprint=spec.fingerprint(),
        expect_graph=served["ref_graph_fp"])
    ids = np.arange(theirs.n)
    np.testing.assert_array_equal(theirs.lookup(ids),
                                  result.embeddings.numpy())
    np.testing.assert_array_equal(theirs.predictions, result.predictions)
    # the reference's bundle in the port's store
    mine = EmbeddingStore.load(
        served["ref_path"], device="cpu",
        expect_fingerprint=result.spec.fingerprint(),
        expect_graph=graph_fingerprint(served["ds"].graph))
    np.testing.assert_array_equal(mine.lookup(ids).numpy(),
                                  served["ref_table"])
    np.testing.assert_array_equal(mine.predictions, served["ref_key"])
    assert mine.k == theirs.k == K


def test_batcher_answers_known_nodes_exactly(served):
    store = EmbeddingStore.load(served["result"].serving_path, device="cpu")
    batcher = ContinuousBatcher(store, max_batch=16, max_neighbors=8)
    workload = make_zipf_workload(store.n, num_queries=400,
                                  unseen_frac=0.1, max_neighbors=8, seed=3)
    row = run_replay(batcher, workload, verify=True)
    assert row["label_mismatches"] == 0
    assert row["known_queries"] == 360
    assert row["served_by_source"]["degraded"] == 1
    assert row["served_by_source"]["inductive"] == 39


def test_inductive_matches_reference_plain_path():
    rng = np.random.default_rng(8)
    b, m, e, c = 8, 32, 16, 5
    mask = (rng.random((b, m)) < 0.4).astype(np.float32)
    mask[3] = 0.0                               # one zero-neighbour query
    nb_emb = rng.normal(size=(b, m, e)).astype(np.float32) * mask[..., None]
    head_w = rng.normal(size=(b, e, c)).astype(np.float32)
    head_b = rng.normal(size=(b, c)).astype(np.float32)
    ref_agg, ref_logits = ref_inductive._aggregate_and_head(
        jnp.asarray(nb_emb), jnp.asarray(mask), jnp.asarray(head_w),
        jnp.asarray(head_b), max_neighbors=m, use_kernel=False)
    agg, logits = aggregate_and_head(
        torch.as_tensor(nb_emb), torch.as_tensor(mask),
        torch.as_tensor(head_w), torch.as_tensor(head_b))
    np.testing.assert_allclose(agg.numpy(), np.asarray(ref_agg),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               rtol=1e-5, atol=1e-5)
    part = rng.integers(0, 4, 50).astype(np.int32)
    for nbs in ([], [3, 3, 7, 60], [-1, 49, 2, 5, 11], list(range(50))):
        pid, known = route_neighbors(part, nbs)
        rpid, rknown = ref_inductive.route_neighbors(part, nbs)
        assert pid == rpid and np.array_equal(known, rknown)


def test_zero_neighbor_query_degrades_not_crashes(served):
    store = EmbeddingStore.load(served["result"].serving_path, device="cpu")
    batcher = ContinuousBatcher(store, max_batch=4, max_neighbors=8)
    batcher.submit(store.n + 5, neighbors=[])
    batcher.submit(store.n + 6, neighbors=[-3, store.n + 99])
    batcher.submit(store.n + 7, neighbors=[0, 1])
    answers = {a.node_id: a for a in batcher.drain()}
    bias_label = int(store.head_b[0].argmax())
    for nid in (store.n + 5, store.n + 6):
        assert answers[nid].source == "degraded"
        assert answers[nid].label == bias_label
        assert not answers[nid].embedding.any()
    assert answers[store.n + 7].source == "inductive"
