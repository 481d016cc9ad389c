"""``python -m repro_torch.serving``: export, replay, verify.

    PYTHONPATH=src python -m repro_torch.serving            # on the GPU
    PYTHONPATH=src python -m repro_torch.serving --device cpu --nodes 500

1. runs the port's inference pipeline with seeded parameters and exports
   a serving bundle;
2. loads it as a sharded :class:`~repro_torch.serving.store.EmbeddingStore`
   and replays a Zipf workload (with unseen nodes and one zero-neighbour
   query) through the continuous batcher;
3. checks every answer for a known node against the offline answer key.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serving",
        description="embedding serving replay: export a bundle from the "
                    "inference pipeline, replay a Zipf workload, verify")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--dataset", default="arxiv-like")
    ap.add_argument("--nodes", type=int, default=2000,
                    help="synthetic dataset size (arxiv-like)")
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hidden-dim", type=int, default=64)
    ap.add_argument("--embed-dim", type=int, default=64)
    ap.add_argument("--bundle-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch-serving"),
        help="where the serving bundle is written")
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--cache-capacity", type=int, default=512,
                    help="LRU hot-node cache size (embedding rows)")
    ap.add_argument("--max-neighbors", type=int, default=32,
                    help="inductive fallback: neighbour-axis size")
    ap.add_argument("--queries", type=int, default=10_000)
    ap.add_argument("--alpha", type=float, default=1.1,
                    help="Zipf exponent of the node popularity law")
    ap.add_argument("--unseen-frac", type=float, default=0.02,
                    help="fraction of queries for nodes outside the store")
    ap.add_argument("--json", action="store_true")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    from repro_torch.pipeline.pipeline import PipelineConfig, run_inference

    from .batcher import ContinuousBatcher
    from .cache import LruNodeCache
    from .replay import make_zipf_workload, run_replay
    from .store import EmbeddingStore

    args = build_parser().parse_args(argv)
    kwargs = {} if args.dataset.replace("-", "_") == "karate" \
        else {"n": args.nodes}
    cfg = PipelineConfig(dataset=args.dataset, k=args.k, seed=args.seed,
                         hidden_dim=args.hidden_dim,
                         embed_dim=args.embed_dim,
                         serving_dir=args.bundle_dir, dataset_kwargs=kwargs)
    result = run_inference(cfg, device=args.device)
    store = EmbeddingStore.load(
        result.serving_path, device=args.device,
        expect_fingerprint=result.spec.fingerprint())
    batcher = ContinuousBatcher(
        store, cache=LruNodeCache(args.cache_capacity),
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        max_neighbors=args.max_neighbors)
    workload = make_zipf_workload(
        store.n, num_queries=args.queries, alpha=args.alpha,
        unseen_frac=args.unseen_frac, max_neighbors=args.max_neighbors,
        seed=args.seed)
    row = run_replay(batcher, workload, verify=True)
    if args.json:
        print(json.dumps(row, indent=2))
    else:
        srcs = ", ".join(f"{k}={v}" for k, v in
                         sorted(row["served_by_source"].items()))
        print(f"{store.summary()}")
        print(f"serving replay: {row['queries']} queries in "
              f"{row['wall_s']:.3f}s ({row['throughput_qps']:.1f} qps) "
              f"on {row['device']}")
        print(f"  latency      p50={row['p50_ms']:.3f}ms "
              f"p99={row['p99_ms']:.3f}ms")
        print(f"  cache        hit_rate={row['cache_hit_rate']}")
        print(f"  answers      {srcs}")
        print(f"  exact-match  {row['known_queries'] - row['label_mismatches']}"
              f"/{row['known_queries']} known-node answers")
    return 0
