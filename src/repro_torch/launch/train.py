"""Training entry point, the reference's ``repro.launch.train``, on the
card.

Two workloads, selected by --workload:

* ``gnn`` (default) — the paper: partition a graph with Leiden-Fusion (or
  another spec via --partitioner), train one GNN per partition with zero
  communication (kernels A and B on the card, one captured step), pool
  the embeddings, train the MLP classifier, report accuracy.
* ``lm`` — train one of the dense transformer configs (--arch) on the
  reference's synthetic batch for --steps steps, one captured CUDA graph
  a step (``repro_torch.launch.steps.make_train_step``). ``--reduced``
  gives the CPU-scale dims; without it the config trains at full width
  and depth (qwen3_4b fits one 80 GB card at batch 4, seq 128).

Under ``python -m torch.distributed.run --nproc-per-node D`` (``WORLD_SIZE``
> 1) the gnn workload trains one shard of the k partitions per rank (the
reference's ``train_local(mesh=...)``) and rank 0 prints the report, with
the collective bytes each phase counted.

The flags, defaults and report keys are the reference's; ``--device``
(default ``cuda``: it raises without a GPU) takes ``cpu`` for the plain
path. The LM report adds ``steady_tokens_per_s`` (steps 2 on, after the
capture), the first step's seconds (on the card: warm-up, capture, one
replay), every step's loss and the peak device memory.

    PYTHONPATH=src python -m repro_torch.launch.train --workload gnn \\
        --partitioner leiden_fusion --k 8 --scheme repli --epochs 60
    PYTHONPATH=src python -m repro_torch.launch.train --workload lm \\
        --arch qwen3_4b --reduced --steps 20 --device cpu
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..checkpoint import save_checkpoint
from ..configs import get_config
from ..core import (build_partition_batch, evaluate_partition,
                    make_arxiv_like, make_proteins_like, partition_from_spec)
from ..device import resolve_device, synchronize
from ..gnn.model import GNNConfig
from ..gnn.distributed import local_mesh
from ..gnn.train import train_classifier, train_local
from ..models.convert import params_to_reference
from ..models.inputs import make_batch
from ..models.lm import init_model
from ..optim import adamw_init
from .mesh import env_world, init_process_group_from_env, make_local_mesh
from .steps import make_train_step


def train_gnn(args: argparse.Namespace, device=None, mesh=None) -> dict:
    """The GNN workload; under ``mesh`` (a ``torch.distributed`` run) each
    rank trains its shard of the k partitions (unsharded, with a warning,
    where the ranks do not divide k) and only rank 0 writes the
    checkpoint."""
    device = resolve_device(args.device if device is None else device)
    t0 = time.time()
    if args.dataset == "arxiv_like":
        ds = make_arxiv_like(n=args.nodes, seed=args.seed)
    else:
        ds = make_proteins_like(n=args.nodes or 6000, seed=args.seed)
    result = partition_from_spec(ds.graph, args.partitioner, args.k,
                                 seed=args.seed)
    labels, t_part = result.labels, result.seconds
    report = evaluate_partition(ds.graph, labels)
    batch = build_partition_batch(ds.graph, labels, scheme=args.scheme)
    cfg = GNNConfig(kind=args.model, feature_dim=ds.features.shape[1],
                    hidden_dim=args.hidden, embed_dim=args.hidden,
                    num_layers=3, dropout=args.dropout)
    mesh = local_mesh(mesh, args.k)
    t2 = time.time()
    trained = train_local(ds, batch, cfg, epochs=args.epochs, lr=args.lr,
                          seed=args.seed, device=device, mesh=mesh)
    t_train = time.time() - t2
    res, _ = train_classifier(ds, trained.embeddings, epochs=150,
                              seed=args.seed)
    out = {
        "workload": "gnn", "dataset": ds.name, "partitioner": result.spec,
        "k": args.k, "scheme": args.scheme, "model": args.model,
        "partition_time_s": round(t_part, 2),
        "train_time_s": round(t_train, 2),
        "partition_quality": report.as_dict(),
        "metric": "rocauc" if ds.multilabel else "accuracy",
        "results": res,
        "total_s": round(time.time() - t0, 1),
    }
    if args.ckpt_dir:
        if not dist.is_initialized() or dist.get_rank() == 0:
            save_checkpoint(args.ckpt_dir, args.epochs, trained.params)
        out["checkpoint"] = args.ckpt_dir
    if trained.collectives is not None:
        out["collectives"] = {p: c["total"] for p, c in
                              trained.collectives["phases"].items()}
    return out


def run_lm(args: argparse.Namespace,
           params: Optional[Dict] = None) -> Tuple[dict, Dict]:
    """The LM workload, through the captured train step; returns
    ``(report, state)``, the state being the config, the trained params,
    the optimizer state, the batch and the step (the card's checks
    profile it further). ``params`` replaces the seeded weights (trained
    in place; the seeded draw differs between the CPU's generator and
    the card's, so a comparison of the two devices hands both the same
    weights)."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if params is None:
        params = init_model(cfg, device, seed=args.seed)
    opt = adamw_init(params)
    batch = make_batch(cfg, batch=args.batch, seq=args.seq, seed=args.seed,
                       device=device)
    step = make_train_step(cfg, lr=args.lr, device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    synchronize(device)
    losses = []
    t0 = time.time()
    t1 = t0
    for i in range(args.steps):
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
        if i == 0:
            t1 = time.time()
    t_end = time.time()
    tokens = args.batch * args.seq
    out = {
        "workload": "lm", "arch": cfg.name, "steps": args.steps,
        "first_loss": losses[0], "last_loss": losses[-1],
        "tokens_per_s": round(args.steps * tokens / (t_end - t0), 1),
        "steady_tokens_per_s": (round((args.steps - 1) * tokens
                                      / (t_end - t1), 1)
                                if args.steps > 1 else None),
        "first_step_s": t1 - t0,
        "losses": losses,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, args.steps,
                        params_to_reference(params, cfg))
        out["checkpoint"] = args.ckpt_dir
    return out, {"cfg": cfg, "params": params, "opt": opt, "batch": batch,
                 "step": step}


def train_lm(args: argparse.Namespace) -> dict:
    return run_lm(args)[0]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--workload", choices=["gnn", "lm"], default="gnn")
    # gnn
    ap.add_argument("--dataset", default="arxiv_like",
                    choices=["arxiv_like", "proteins_like"])
    ap.add_argument("--nodes", type=int, default=8000)
    ap.add_argument("--partitioner", default="leiden_fusion",
                    help="partitioner spec string, e.g. "
                         "\"lpa+f(alpha=0.1)\" (DESIGN.md §9)")
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--scheme", default="repli", choices=["inner", "repli"])
    ap.add_argument("--model", default="gcn", choices=["gcn", "sage"])
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--dropout", type=float, default=0.3)
    ap.add_argument("--epochs", type=int, default=60)
    # lm
    ap.add_argument("--arch", default="qwen3_4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    # common
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    if env_world() <= 1:
        out = train_gnn(args) if args.workload == "gnn" else train_lm(args)
        print(json.dumps(out, indent=1))
        return
    if args.workload != "gnn":
        raise ValueError("under torch.distributed.run only the gnn workload "
                         "runs (one shard of the partitions per rank); the "
                         "lm workload runs in one process")
    device, _ = init_process_group_from_env(args.device)
    try:
        out = train_gnn(args, device=device, mesh=make_local_mesh())
        if dist.get_rank() == 0:
            print(json.dumps(out, indent=1))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
