"""Leiden-Fusion placement of MoE experts, on the PyTorch port (the twin
of ``examples/moe_expert_placement.py``).

Simulates a skewed router (experts co-activate in topic clusters), builds
the co-activation graph, and compares the LF placement against the naive
contiguous split on the all-to-all dispersion metric; then does the same
on a real router trace: a reduced qwen2-moe (16 experts) trained for 25
steps through the port's train step on topic-banded text, its layer-0
router read through ``repro_torch.core.expert_placement.router_top_k``.
It runs on the GPU by default (the train step one captured CUDA graph);
``--device cpu`` runs the plain PyTorch path.

    PYTHONPATH=src python examples/moe_expert_placement_torch.py
    PYTHONPATH=src python examples/moe_expert_placement_torch.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.expert_placement import (contiguous_placement,
                                               lf_expert_placement,
                                               placement_cost, router_top_k)
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models.layers import apply_norm
from repro_torch.models.lm import init_model
from repro_torch.optim import adamw_init


def synthetic_router_trace(num_experts=60, top_k=4, tokens=20000,
                           num_topics=12, seed=0):
    """Tokens belong to latent topics; each topic prefers a small expert
    subset (how real MoE routers behave after training)."""
    rng = np.random.default_rng(seed)
    topic_experts = [rng.choice(num_experts, size=8, replace=False)
                     for _ in range(num_topics)]
    out = np.zeros((tokens, top_k), dtype=np.int64)
    for t in range(tokens):
        prefer = topic_experts[rng.integers(num_topics)]
        # 80% from the topic's preferred experts, 20% uniform
        choices = []
        while len(choices) < top_k:
            e = (rng.choice(prefer) if rng.random() < 0.8
                 else rng.integers(num_experts))
            if e not in choices:
                choices.append(int(e))
        out[t] = choices
    return out


def real_router_trace(device, tokens_per_topic=48, num_topics=24, steps=25,
                      seed=0):
    """A real router trace: a reduced qwen2-moe trained briefly on
    topic-banded text (each sequence draws its token ids from one band),
    then its layer-0 router's top-k choices. Training specializes experts
    to topics, which gives the co-activation structure LF exploits."""
    cfg = get_config("qwen2_moe_a2p7b").reduced(num_experts=16)
    rng = np.random.default_rng(seed)
    bands = np.array_split(np.arange(16, cfg.vocab_size), num_topics)
    seqs = [rng.choice(bands[t], size=tokens_per_topic)
            for t in range(num_topics) for _ in range(2)]
    tokens = torch.as_tensor(np.stack(seqs), dtype=torch.int32,
                             device=device)
    batch = {"tokens": tokens,
             "loss_mask": torch.ones(tokens.shape, device=device)}
    params = init_model(cfg, device, seed=seed)
    opt = adamw_init(params)
    step = make_train_step(cfg, lr=3e-3, device=device)
    for _ in range(steps):
        step(params, opt, batch)
    # the trained router's choices at layer 0, on the embedded tokens
    lp = params["layers"][0]
    with torch.no_grad():
        h = apply_norm(lp["ln2"], params["embed"][tokens.long()])
    return router_top_k(lp["ffn"], cfg, h), cfg.num_experts


def compare(trace, num_experts, shards, p90=False):
    """Print the contiguous and LF placements' costs; returns both mean
    shard counts."""
    naive = contiguous_placement(num_experts, shards)
    lf = lf_expert_placement(trace, num_experts, shards)
    means = []
    for name, placement in (("contiguous", naive), ("leiden_fusion", lf)):
        cost = placement_cost(trace, placement)
        means.append(cost["mean_shards_per_token"])
        line = (f"{name:14s}: mean shards/token="
                f"{cost['mean_shards_per_token']:.3f}  "
                f"single-shard tokens={cost['single_shard_frac']*100:.1f}%")
        if p90:
            line += f"  p90={cost['p90_shards_per_token']:.0f}"
        print(line)
    return means


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    device = resolve_device(ap.parse_args(argv).device)
    print("== synthetic clustered router (qwen2-moe geometry, 60e/4 shards)")
    num_experts, shards = 60, 4    # qwen2-moe-a2.7b geometry, 4-way EP group
    trace = synthetic_router_trace(num_experts)
    c_naive, c_lf = compare(trace, num_experts, shards, p90=True)
    print(f"all-to-all partner reduction: "
          f"{(1 - (c_lf - 1) / max(c_naive - 1, 1e-9)) * 100:.1f}% "
          f"fewer cross-shard hops")

    print("\n== REAL router trace (reduced qwen2-moe trained on topic-"
          "clustered text, 16e/4 shards)")
    trace, e = real_router_trace(device)
    compare(trace, e, 4)


if __name__ == "__main__":
    main()
