"""The port's partition stage against the reference package: datasets,
graph fingerprints, Leiden-Fusion labels, partitioner fingerprints and the
assembled partition batches are all exactly equal."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import PartitionerSpec                          # noqa: E402
from repro.core import build_partition_batch as ref_batch       # noqa: E402
from repro.core import make_arxiv_like as ref_arxiv             # noqa: E402
from repro.core import partition_from_spec                      # noqa: E402
from repro.pipeline.datasets import graph_fingerprint as ref_fp  # noqa: E402
from repro.pipeline.datasets import make_karate_dataset as ref_karate  # noqa
from repro_torch.core import (LeidenFusionConfig,               # noqa: E402
                              build_partition_batch, make_arxiv_like)
from repro_torch.core import PartitionerSpec as MySpec          # noqa: E402
from repro_torch.core import \
    partition_from_spec as my_partition_from_spec               # noqa: E402
from repro_torch.pipeline.datasets import (graph_fingerprint,   # noqa: E402
                                           make_karate_dataset)

GRAPH_FIELDS = ("indptr", "indices", "edge_weight", "node_weight",
                "self_weight")
DATASET_FIELDS = ("features", "labels", "train_mask", "val_mask",
                  "test_mask")


@pytest.fixture(scope="module")
def datasets():
    return {"karate": (make_karate_dataset(), ref_karate()),
            "arxiv2000": (make_arxiv_like(n=2000), ref_arxiv(n=2000))}


@pytest.mark.parametrize("name", ["karate", "arxiv2000"])
def test_datasets_are_byte_identical(datasets, name):
    mine, ref = datasets[name]
    assert mine.graph.n == ref.graph.n
    for field in GRAPH_FIELDS:
        a, b = getattr(mine.graph, field), getattr(ref.graph, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    for field in DATASET_FIELDS:
        a, b = getattr(mine, field), getattr(ref, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert (mine.num_classes, mine.name) == (ref.num_classes, ref.name)
    assert graph_fingerprint(mine.graph) == ref_fp(ref.graph)


@pytest.mark.parametrize("name", ["karate", "arxiv2000"])
@pytest.mark.parametrize("k", [2, 4])
def test_leiden_fusion_labels_equal(datasets, name, k):
    mine, ref = datasets[name]
    labels = my_partition_from_spec(mine.graph, "leiden_fusion", k,
                                    seed=0).labels
    expect = partition_from_spec(ref.graph, "leiden_fusion", k, seed=0)
    assert np.array_equal(labels, expect.labels)
    assert labels.max() + 1 == k


@pytest.mark.parametrize("overrides", [{}, {"alpha": 0.1, "beta": 0.3},
                                       {"resolution": 0.5}])
def test_partitioner_fingerprint_matches_spec(overrides):
    cfg = MySpec(method="leiden_fusion",
                 config=LeidenFusionConfig(**overrides))
    spec = PartitionerSpec.parse("leiden_fusion")
    spec = dataclasses.replace(
        spec, config=dataclasses.replace(spec.config, **overrides))
    assert cfg.fingerprint() == spec.fingerprint()
    assert cfg.canonical() == spec.canonical()


@pytest.mark.parametrize("scheme", ["inner", "repli"])
def test_partition_batches_equal(datasets, scheme):
    mine, ref = datasets["arxiv2000"]
    labels = my_partition_from_spec(mine.graph, "leiden_fusion", 4).labels
    a = build_partition_batch(mine.graph, labels, scheme=scheme)
    b = ref_batch(ref.graph, labels, scheme=scheme)
    assert (a.n_pad, a.e_pad) == (b.n_pad, b.e_pad)
    for field in ("node_ids", "node_mask", "owned_mask", "edge_src",
                  "edge_dst", "edge_weight", "in_degree"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and np.array_equal(x, y), field
