"""``python -m repro_torch.pipeline``: the training pipeline, the partition
artifact cache, and the partitioner registry.

    PYTHONPATH=src python -m repro_torch.pipeline run              # GPU
    PYTHONPATH=src python -m repro_torch.pipeline run --device cpu \\
        --dataset karate --k 4 --epochs 3 --classifier-epochs 5 \\
        --method "metis+f" --cache-dir /tmp/c
    PYTHONPATH=src python -m repro_torch.pipeline cache --cache-dir /tmp/c
    PYTHONPATH=src python -m repro_torch.pipeline cache --clear
    PYTHONPATH=src python -m repro_torch.pipeline partitioners [--json]

``run`` partitions, trains k GNN replicas (``--mode local``, the paper's
scheme with no communication; ``sync``, the halo-exchange baseline;
``stale``, the exchange every ``--sync-period`` epochs), pools their
embeddings, trains the classifier and prints a report with the
reference's collective bytes of the step. ``--method``
takes any partitioner spec string (``metis``, ``"lpa(max_iter=30)+f"``,
``"leiden_fusion(resolution=0.5)"``); ``partitioners`` lists the registry.
With ``--cache-dir`` a run loads its partition and assembly from the
artifact cache there, or computes and stores them; the entries are the
reference package's, and either package hits the other's. Unlike the
reference CLI, which caches under the home directory by default, the port
caches only where it is told to (``--no-cache`` turns a given
``--cache-dir`` off). ``--trace PATH`` traces the run and writes the
reference's Chrome trace document (``python -m repro_torch.obs summarize
PATH``, or the reference's ``python -m repro.obs``); ``--torch-profile
DIR`` runs ``torch.profiler`` over the training stage (the reference's
``--jax-profile``); ``--checkpoint-dir DIR`` saves the trained parameters
in the reference's checkpoint layout. ``--kernel-autotune`` tunes the
kernels' strategy and knobs for the run's shape buckets before training
and caches the winners (``REPRO_TORCH_AUTOTUNE_CACHE``, default
``~/.cache/repro_torch/autotune_cache.json``); on the CPU the one
candidate is the plain versions, and nothing is measured. There is no
``--use-kernel``: on the card the layers always run the kernels. The flags
are the reference CLI's that the ported modes read; ``--device`` defaults
to ``cuda``.

Started by ``python -m torch.distributed.run --nproc-per-node k`` (so that
``WORLD_SIZE`` > 1), ``run`` joins the process group
(:func:`repro_torch.launch.mesh.init_process_group_from_env`, which picks
gloo or nccl and the rank's card) and trains one shard of the partitions
per rank: local mode shards the k partitions over the ranks, sync and
stale need k ranks. Rank 0 alone prints the report and writes the files;
every rank prints one ``rank summary:`` JSON line to stderr. Without
``WORLD_SIZE`` it runs in one process, as ever.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.pipeline",
        description="Leiden-Fusion pipeline on PyTorch: partition -> "
                    "GNN training (communication-free, or the sync and "
                    "stale halo-exchange baselines) -> embedding assembly "
                    "-> node classification.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="run the training pipeline once")
    run.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    run.add_argument("--dataset", default="arxiv-like",
                     help="karate | arxiv-like | proteins(-like)")
    run.add_argument("--nodes", type=int, default=None,
                     help="node count override for synthetic datasets")
    run.add_argument("--dataset-scale", type=float, default=None,
                     help="node-count multiplier for synthetic datasets "
                          "(169343/40000 on arxiv-like gives the "
                          "ogbn-arxiv node count)")
    run.add_argument("--method", default="leiden_fusion",
                     help="partitioner spec, e.g. leiden_fusion | metis | "
                          "\"lpa+f(alpha=0.1)\"; see the 'partitioners' "
                          "subcommand")
    run.add_argument("--k", type=int, default=8)
    run.add_argument("--seed", type=int, default=0)
    run.add_argument("--scheme", default="repli", choices=["inner", "repli"])
    run.add_argument("--mode", default="local",
                     choices=["local", "sync", "stale"],
                     help="local = zero communication (the paper); sync = "
                          "halo exchange every step; stale = exchange every "
                          "--sync-period epochs, frozen halos in between")
    run.add_argument("--sync-period", type=int, default=4,
                     help="stale mode: halo-exchange period in epochs "
                          "(1 ≡ sync, 0 = never exchange ≡ local)")
    run.add_argument("--integrate", default="none",
                     choices=["none", "model_avg", "ensemble"],
                     help="aggregate the k partition models before "
                          "embedding assembly")
    run.add_argument("--model", default="gcn", choices=["gcn", "sage"])
    run.add_argument("--kernel-autotune", action="store_true",
                     help="sweep the kernels' strategy and knobs (kernel "
                          "B's row tile, kernel A's split) for this run's "
                          "shape buckets before training and cache the "
                          "winners on disk (REPRO_TORCH_AUTOTUNE_CACHE); on "
                          "the CPU the plain versions are the one candidate")
    run.add_argument("--hidden-dim", type=int, default=128)
    run.add_argument("--embed-dim", type=int, default=128)
    run.add_argument("--num-layers", type=int, default=3)
    run.add_argument("--dropout", type=float, default=0.3)
    run.add_argument("--epochs", type=int, default=60)
    run.add_argument("--lr", type=float, default=5e-3)
    run.add_argument("--classifier-epochs", type=int, default=150)
    run.add_argument("--cache-dir", default=None,
                     help="partition artifact cache directory (default: "
                          "no cache)")
    run.add_argument("--no-cache", action="store_true",
                     help="disable the partition artifact cache")
    run.add_argument("--checkpoint-dir", default=None,
                     help="save trained per-partition params here")
    run.add_argument("--serving-dir", default=None,
                     help="export a serving bundle here (requires "
                          "--classifier-epochs > 0)")
    run.add_argument("--low-memory", action="store_true",
                     help="train partitions one at a time (same math, one "
                          "partition's tensors on the device at a time)")
    run.add_argument("--trace", default=None, metavar="PATH",
                     help="enable repro_torch.obs tracing and export a "
                          "Chrome trace-event JSON here after the run (open "
                          "in Perfetto; aggregate with 'python -m "
                          "repro_torch.obs summarize PATH')")
    run.add_argument("--torch-profile", default=None, metavar="DIR",
                     help="run torch.profiler around the training stage, "
                          "writing its Chrome trace to DIR")
    run.add_argument("--json", action="store_true",
                     help="print the report as JSON instead of the summary")

    cache = sub.add_parser("cache", help="list or clear the artifact cache")
    cache.add_argument("--cache-dir", required=True)
    cache.add_argument("--list", action="store_true", default=True,
                       help="list the entries (the default)")
    cache.add_argument("--clear", action="store_true")

    part = sub.add_parser("partitioners",
                          help="list the registered partitioners with their "
                               "config fields and capability flags")
    part.add_argument("--json", action="store_true",
                      help="machine-readable schema dump")
    return ap


def _cmd_cache(args: argparse.Namespace) -> int:
    from .artifacts import PartitionArtifactStore
    store = PartitionArtifactStore(args.cache_dir)
    if args.clear:
        print(f"removed {store.clear()} artifact(s) from {store.cache_dir}")
        return 0
    entries = store.entries()
    if not entries:
        print(f"cache empty: {store.cache_dir}")
        return 0
    for name, size in entries:
        print(f"{size:>12d}  {name}")
    print(f"{sum(size for _, size in entries):>12d}  total "
          f"({len(entries)} artifacts) in {store.cache_dir}")
    return 0


def _config_schema(config_type) -> dict:
    out = {}
    for f in dataclasses.fields(config_type):
        default = f.default if f.default is not dataclasses.MISSING else None
        out[f.name] = {"type": getattr(f.type, "__name__", str(f.type)),
                       "default": default,
                       "help": f.metadata.get("help", "")}
    return out


def _print_fields(config_type) -> None:
    schema = _config_schema(config_type)
    if not schema:
        print(f"{'':16s}   (no config fields)")
    for field, info in schema.items():
        hint = f"  — {info['help']}" if info["help"] else ""
        print(f"{'':16s}   {field}: {info['type']} = "
              f"{info['default']!r}{hint}")


def _cmd_partitioners(args: argparse.Namespace) -> int:
    from repro_torch.core import FusionConfig, registered_partitioners
    entries = registered_partitioners()
    if args.json:
        payload = {
            name: {"capabilities": dataclasses.asdict(e.capabilities),
                   "config": e.config_type.__name__,
                   "fields": _config_schema(e.config_type), "doc": e.doc}
            for name, e in entries.items()}
        payload["+f"] = {
            "doc": "fusion combinator over any base method (paper §5.4)",
            "config": FusionConfig.__name__,
            "fields": _config_schema(FusionConfig)}
        print(json.dumps(payload, indent=2))
        return 0
    for name, e in entries.items():
        print(f"{name:16s} [{e.capabilities.describe()}]  {e.doc}")
        _print_fields(e.config_type)
    print()
    print("+f               fusion combinator: any spec may end in "
          "\"+f(...)\" (paper §5.4)")
    _print_fields(FusionConfig)
    print()
    print("spec grammar: method | method(field=value,...) | base+f | "
          "base(...)+f(field=value,...)")
    return 0


def config_from_args(args: argparse.Namespace):
    """The :class:`~repro_torch.pipeline.pipeline.PipelineConfig` of a
    parsed ``run`` command line."""
    from .pipeline import PipelineConfig
    dataset_kwargs = {}
    if args.nodes is not None:
        dataset_kwargs["n"] = args.nodes
    if args.dataset_scale is not None:
        dataset_kwargs["scale"] = args.dataset_scale
    return PipelineConfig(
        dataset=args.dataset, method=args.method, k=args.k, seed=args.seed,
        scheme=args.scheme,
        mode=args.mode, sync_period=args.sync_period,
        integrate=args.integrate, model=args.model,
        hidden_dim=args.hidden_dim, embed_dim=args.embed_dim,
        num_layers=args.num_layers, dropout=args.dropout,
        epochs=args.epochs, lr=args.lr,
        classifier_epochs=args.classifier_epochs,
        low_memory=args.low_memory, serving_dir=args.serving_dir,
        cache_dir=None if args.no_cache else args.cache_dir,
        checkpoint_dir=args.checkpoint_dir,
        torch_profile_dir=args.torch_profile,
        kernel_autotune=args.kernel_autotune,
        dataset_kwargs=dataset_kwargs)


def rank_summary(result, device, backend: str) -> dict:
    """One rank's line of a distributed run: its counted collectives by
    step and phase, its kernels' launches, its losses and epoch time, and
    its peak device memory."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import ops
    counted = result.counted or {}
    return {
        "rank": dist.get_rank(), "world": dist.get_world_size(),
        "backend": backend, "device": str(device),
        "partitions": counted.get("partitions"),
        "step_bytes": [s["total"] for s in counted.get("steps", [])],
        "phases": {p: c["total"] for p, c in
                   counted.get("phases", {}).items()},
        "seconds": counted.get("seconds"),
        "launches": ops.launch_counts(),
        "losses": result.losses.tolist(),
        "train_epochs_s": result.timings.get("train_epochs"),
        "peak_device_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                           if device.type == "cuda" else None)}


def _cmd_run(args: argparse.Namespace) -> int:
    from repro_torch.launch.mesh import env_world, init_process_group_from_env
    if env_world() <= 1:
        return _run(args, args.device)
    import torch.distributed as dist
    device, backend = init_process_group_from_env(args.device)
    try:
        return _run(args, device, backend)
    finally:
        dist.destroy_process_group()


def _run(args: argparse.Namespace, device, backend: Optional[str] = None
         ) -> int:
    """``run`` in this process; under a process group (``backend``) every
    rank trains its shard, rank 0 alone writes the trace and prints the
    report, and every rank prints :func:`rank_summary` to stderr."""
    from repro_torch import obs

    from .pipeline import PipelineReport, run_training

    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    rank0 = backend is None or _rank() == 0
    if args.trace:
        obs.enable()
    cfg = config_from_args(args)
    result = run_training(cfg, device=device)
    if backend is not None:
        print("rank summary: " + json.dumps(rank_summary(result, device,
                                                         backend)),
              file=sys.stderr, flush=True)
    if not rank0:
        return 0
    report = PipelineReport.of(cfg, result)
    if args.trace:
        path = obs.export_trace(args.trace)
        print(f"trace written: {path} ({obs.tracer().event_count()} spans) "
              f"- summarize with 'python -m repro_torch.obs summarize "
              f"{path}'", file=sys.stderr)
    if args.torch_profile:
        print(f"torch.profiler trace: {result.profile_path}",
              file=sys.stderr)
    if args.json:
        print(json.dumps(report.as_dict(), indent=2))
    else:
        print(report.summary())
    return 0


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank()


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "run":
        return _cmd_run(args)
    if args.cmd == "partitioners":
        return _cmd_partitioners(args)
    return _cmd_cache(args)
