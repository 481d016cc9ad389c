"""``python -m repro_torch.pipeline run``: the training pipeline.

    PYTHONPATH=src python -m repro_torch.pipeline run              # GPU
    PYTHONPATH=src python -m repro_torch.pipeline run --device cpu \\
        --dataset karate --k 4 --epochs 3 --classifier-epochs 5

Partition, train k GNN replicas locally (no communication), pool their
embeddings, train the classifier and print a report. The flags are the
reference CLI's that local mode reads; ``--device`` defaults to ``cuda``.
"""
from __future__ import annotations

import argparse
import json
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.pipeline",
        description="Leiden-Fusion pipeline on PyTorch: partition -> "
                    "communication-free GNN training -> embedding assembly "
                    "-> node classification.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="run the training pipeline once")
    run.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    run.add_argument("--dataset", default="arxiv-like",
                     help="karate | arxiv-like")
    run.add_argument("--nodes", type=int, default=None,
                     help="node count override for synthetic datasets")
    run.add_argument("--dataset-scale", type=float, default=None,
                     help="node-count multiplier for synthetic datasets "
                          "(169343/40000 on arxiv-like gives the "
                          "ogbn-arxiv node count)")
    run.add_argument("--k", type=int, default=8)
    run.add_argument("--seed", type=int, default=0)
    run.add_argument("--scheme", default="repli", choices=["inner", "repli"])
    run.add_argument("--mode", default="local",
                     choices=["local", "sync", "stale"],
                     help="only local (zero communication, the paper) is "
                          "ported; sync and stale raise")
    run.add_argument("--integrate", default="none",
                     choices=["none", "model_avg", "ensemble"],
                     help="aggregate the k partition models before "
                          "embedding assembly")
    run.add_argument("--model", default="gcn", choices=["gcn", "sage"])
    run.add_argument("--hidden-dim", type=int, default=128)
    run.add_argument("--embed-dim", type=int, default=128)
    run.add_argument("--num-layers", type=int, default=3)
    run.add_argument("--dropout", type=float, default=0.3)
    run.add_argument("--epochs", type=int, default=60)
    run.add_argument("--lr", type=float, default=5e-3)
    run.add_argument("--classifier-epochs", type=int, default=150)
    run.add_argument("--serving-dir", default=None,
                     help="export a serving bundle here (requires "
                          "--classifier-epochs > 0)")
    run.add_argument("--low-memory", action="store_true",
                     help="train partitions one at a time (same math, one "
                          "partition's tensors on the device at a time)")
    run.add_argument("--json", action="store_true",
                     help="print the report as JSON instead of the summary")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    from .pipeline import PipelineConfig, PipelineReport, run_training

    args = build_parser().parse_args(argv)
    dataset_kwargs = {}
    if args.nodes is not None:
        dataset_kwargs["n"] = args.nodes
    if args.dataset_scale is not None:
        dataset_kwargs["scale"] = args.dataset_scale
    cfg = PipelineConfig(
        dataset=args.dataset, k=args.k, seed=args.seed, scheme=args.scheme,
        mode=args.mode, integrate=args.integrate, model=args.model,
        hidden_dim=args.hidden_dim, embed_dim=args.embed_dim,
        num_layers=args.num_layers, dropout=args.dropout,
        epochs=args.epochs, lr=args.lr,
        classifier_epochs=args.classifier_epochs,
        low_memory=args.low_memory, serving_dir=args.serving_dir,
        dataset_kwargs=dataset_kwargs)
    report = PipelineReport.of(cfg, run_training(cfg, device=args.device))
    if args.json:
        print(json.dumps(report.as_dict(), indent=2))
    else:
        print(report.summary())
    return 0
