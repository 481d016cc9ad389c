"""Partition-sharded embedding serving: bundle export and load, an LRU
hot-node cache, a continuous batcher, and an inductive fallback that
averages a new node's neighbours through the aggregation kernel.

Entry points:

- ``python -m repro_torch.serving`` — export (or reuse) a trained bundle,
  replay a Zipf workload, verify (``replay``, the default)
- ``python -m repro_torch.serving serve`` / ``client`` — multi-process
  layout over the reference's JSON-lines protocol
- :func:`export_from_pipeline` — bundle export hook (called by the pipeline
  when ``PipelineConfig.serving_dir`` is set)
- :class:`EmbeddingStore` / :class:`ContinuousBatcher` — library use
"""
from .batcher import (Answer, CompileLog, ContinuousBatcher, Query,
                      bucket_of, bucket_sizes)
from .cache import LruNodeCache
from .inductive import InductiveEngine, route_neighbors
from .replay import (DEFAULT_BENCH_JSON, append_bench_rows, bench_row,
                     make_zipf_workload, run_replay)
from .store import (SERVING_VERSION, EmbeddingStore, ShardStore,
                    StaleServingArtifact, export_from_pipeline,
                    export_serving_bundle)

__all__ = [
    "Answer", "CompileLog", "ContinuousBatcher", "Query", "bucket_of",
    "bucket_sizes",
    "LruNodeCache",
    "InductiveEngine", "route_neighbors",
    "DEFAULT_BENCH_JSON", "append_bench_rows", "bench_row",
    "make_zipf_workload", "run_replay",
    "SERVING_VERSION", "EmbeddingStore", "ShardStore",
    "StaleServingArtifact", "export_from_pipeline", "export_serving_bundle",
]
