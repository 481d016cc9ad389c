"""LM serving: bucketed prefill -> decode loop, on the card by default.

Requests are grouped into power-of-two prompt-length buckets; each bucket
shares one padded prefill and decodes in lock-step with per-request
lengths. The prompts, their lengths and the buckets come from the same
numpy seed, drawn in the same order, as the reference launcher's, and the
report has its keys. A bucket's batch (:func:`bucket_batch`) holds its
tokens and the frontends' stub inputs, drawn right after them: a VLM's
``patch_embeds`` (``num_patch_tokens`` a row, which replace the prompt's
first positions, so a bucket shorter than that raises ``ValueError``, as
``prefill_step`` does: phi-3-vision's 576 patches need prompts of 577 to
1,024 tokens, the 1,024 bucket), or an enc-dec model's ``frames`` (``max(8,
bucket // 8)`` a row), whose encoding the cache keeps as ``memory``.

The decode step (:func:`repro_torch.launch.steps.make_decode_step`, then
the argmax and the length's increment) is a
:class:`repro_torch.graphs.CapturedStep` of its own for each bucket, all
in one graph pool: one CUDA graph per bucket on the card, the bucket's
grown cache bound by address (written in place by the graph: K/V rows,
MLA's ckv/krope rows, and, for the SSM and hybrid families, every block's
recurrent state; an enc-dec cache's ``memory`` is bound and only read),
the token and lengths donated. A step of its own, because a cache is bound by
address: two buckets of an SSM (whose states have no sequence axis) may
give the decode the same shapes, and so one signature, with two caches.
``decode_compiles`` counts the graphs, one per bucket, which is the
reference's count (one jit compile per bucket shape) wherever the buckets'
shapes differ, as every K/V cache's do.
Prefill runs once per bucket and stays eager: ``prefill_compiles`` is the
number of prefill graphs, 0 (the reference compiles one per bucket).
``capture=False`` decodes eagerly (``decode_compiles`` 0).

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch qwen3_4b --reduced --requests 4 --max-new 16
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device, synchronize
from ..graphs import CapturedStep, new_pool
from ..models.config import ModelConfig
from ..models.layers import torch_dtype
from ..models.lm import SEQ_LEAVES, grow_cache, init_model
from .steps import make_decode_step, make_prefill_step

MIN_PREFILL_BUCKET = 8


def prefill_bucket(length: int) -> int:
    """Smallest power-of-two >= length (floored at MIN_PREFILL_BUCKET)."""
    b = MIN_PREFILL_BUCKET
    while b < length:
        b *= 2
    return b


def bucket_batch(rng: np.random.Generator, cfg: ModelConfig, n: int,
                 s_b: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """One bucket's prefill batch, drawn from ``rng`` in the reference
    launcher's order: ``tokens [n, s_b]``, then a VLM's ``patch_embeds
    [n, num_patch_tokens, d]`` or an enc-dec model's ``frames [n, max(8,
    s_b // 8), d]``, N(0, 0.02) in the config's dtype."""
    batch = {"tokens": torch.as_tensor(rng.integers(1, cfg.vocab_size,
                                                    (n, s_b)),
                                       dtype=torch.int32, device=device)}
    widths = {"vision": ("patch_embeds", cfg.num_patch_tokens),
              "audio": ("frames", max(8, s_b // 8))}
    if cfg.frontend in widths:
        name, width = widths[cfg.frontend]
        batch[name] = torch.as_tensor(
            rng.normal(0, 0.02, (n, width, cfg.d_model)),
            dtype=torch_dtype(cfg), device=device)
    return batch


def make_decode(params: Dict, cfg, device: torch.device,
                capture: bool = True, pool=None):
    """``decode(tokens [B, 1], lengths [B], cache) -> (next tokens,
    lengths + 1, logits [B, V])``: one greedy decode step, writing the
    cache in place; a :class:`CapturedStep` (tokens and lengths donated,
    the cache borrowed; its graphs in ``pool``, default its own) or, with
    ``capture=False``, eager."""
    step = make_decode_step(cfg)

    def decode(tokens, lengths, cache):
        logits, _ = step(params, tokens, cache, lengths)
        return (logits.argmax(dim=-1).to(torch.int32)[:, None], lengths + 1,
                logits)
    if not capture:
        return decode

    def warmup(tokens, lengths, cache):
        # a K/V (or ckv/krope) row written twice holds the same values, but
        # a recurrent state would advance twice (warm-up, then the first
        # replay): the warm-up steps copies of the states
        decode(tokens, lengths, _state_copies(cache))
    return CapturedStep(decode, device, pool=pool, donate=(0, 1),
                        borrow=(2,), name="decode", warmup=warmup)


def _state_copies(cache: Dict) -> Dict:
    """``cache`` with every recurrent state (a per-layer cache's leaves
    other than ``k``/``v``/``ckv``/``krope``) copied. K/V, MLA's latent
    ``ckv``/``krope`` and a stacked cache (its ``first_dense`` entries
    too) are shared: a row the warm-up writes, the first replay writes
    again with the same values. An enc-dec cache's ``memory``, which
    decode only reads, is shared too: the warm-up and the graph read the
    tensor the cache holds, and no step copies it."""
    if not isinstance(cache["layers"], list):
        return cache
    return {**cache, "layers": [
        {n: t if n in SEQ_LEAVES else t.clone() for n, t in c.items()}
        for c in cache["layers"]]}


def serve(args: argparse.Namespace, params: Optional[Dict] = None,
          capture: bool = True, cfg: Optional[ModelConfig] = None) -> dict:
    """Serve ``args.requests`` synthetic requests; returns the report.

    ``params`` replaces the seeded weights (the tests pass the reference's,
    through :func:`repro_torch.models.convert.params_from_reference`);
    ``capture=False`` decodes eagerly; ``cfg`` replaces the config that
    ``args.arch`` and ``args.reduced`` name (a depth-cut full-width
    config, say)."""
    device = resolve_device(getattr(args, "device", "cuda"))
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    rng = np.random.default_rng(args.seed)
    if params is None:
        params = init_model(cfg, device, seed=args.seed)
    pool = new_pool(device) if capture else None
    prefill = make_prefill_step(cfg)

    lengths = rng.integers(args.min_prompt, args.max_prompt + 1,
                           args.requests)
    buckets = np.array([prefill_bucket(int(s)) for s in lengths])

    gen = np.zeros((args.requests, args.max_new), dtype=np.int64)
    finite = True
    t_prefill = t_decode = 0.0
    bucket_counts: dict = {}
    compiles = 0
    with torch.no_grad():
        for s_b in sorted(set(buckets.tolist())):
            decode = make_decode(params, cfg, device, capture, pool)
            idx = np.where(buckets == s_b)[0]
            bucket_counts[int(s_b)] = int(idx.size)
            batch = bucket_batch(rng, cfg, idx.size, s_b, device)
            t0 = time.perf_counter()
            logits, cache, _ = prefill(params, batch)
            cache = grow_cache(cache, s_b + args.max_new)
            # per-request lengths start at each prompt's own length, so
            # decode masks (and overwrites) the bucket's padding
            cur_len = torch.as_tensor(lengths[idx], dtype=torch.int32,
                                      device=device)
            synchronize(device)
            t_prefill += time.perf_counter() - t0

            t1 = time.perf_counter()
            next_tok = logits.argmax(dim=-1).to(torch.int32)[:, None]
            steps = torch.empty((idx.size, args.max_new), dtype=torch.int32,
                                device=device)
            for i in range(args.max_new):
                steps[:, i:i + 1] = next_tok    # before a replay rewrites it
                next_tok, cur_len, logits = decode(next_tok, cur_len, cache)
            gen[idx] = steps.cpu().numpy()
            compiles += getattr(decode, "compiles", 0)
            t_decode += time.perf_counter() - t1
            finite = finite and bool(torch.isfinite(logits).all())

    return {
        "arch": cfg.name, "requests": args.requests,
        "prompt_lengths": lengths.tolist(),
        "prefill_buckets": {str(k): v
                            for k, v in sorted(bucket_counts.items())},
        "prefill_compiles": 0,
        "decode_compiles": compiles,
        "new_tokens": args.max_new,
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_per_s": args.requests * args.max_new
        / max(t_decode, 1e-9),
        "finite": finite,
        "sample_generation": gen[0, :8].tolist(),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen3_4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--min-prompt", type=int, default=8)
    ap.add_argument("--max-prompt", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap


def main(argv=None) -> None:
    print(json.dumps(serve(parser().parse_args(argv)), indent=1))


if __name__ == "__main__":
    main()
