"""LM serving: bucketed prefill -> decode loop, on the card by default.

Requests are grouped into power-of-two prompt-length buckets; each bucket
shares one padded prefill and decodes in lock-step with per-request
lengths. The prompts, their lengths and the buckets come from the same
numpy seed, drawn in the same order, as the reference launcher's, and the
report has its keys.

The decode step (:func:`repro_torch.models.lm.serve_step`, then the
argmax and the length's increment) is a
:class:`repro_torch.graphs.CapturedStep`: one CUDA graph per bucket on
the card, the bucket's grown cache bound by address (written in place by
the graph), the token and lengths donated. ``decode_compiles`` counts its
graphs, which is the reference's count (one jit compile per bucket).
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
from ..graphs import CapturedStep
from ..models.lm import grow_cache, init_model, prefill_step, serve_step

MIN_PREFILL_BUCKET = 8


def prefill_bucket(length: int) -> int:
    """Smallest power-of-two >= length (floored at MIN_PREFILL_BUCKET)."""
    b = MIN_PREFILL_BUCKET
    while b < length:
        b *= 2
    return b


def make_decode(params: Dict, cfg, device: torch.device,
                capture: bool = True):
    """``decode(tokens [B, 1], lengths [B], cache) -> (next tokens,
    lengths + 1, logits [B, V])``: one greedy decode step, writing the
    cache in place; a :class:`CapturedStep` (tokens and lengths donated,
    the cache borrowed) or, with ``capture=False``, eager."""
    def decode(tokens, lengths, cache):
        logits, _ = serve_step(params, cfg, tokens, cache, lengths)
        return (logits.argmax(dim=-1).to(torch.int32)[:, None], lengths + 1,
                logits)
    if not capture:
        return decode
    return CapturedStep(decode, device, donate=(0, 1), borrow=(2,),
                        name="decode")


def serve(args: argparse.Namespace, params: Optional[Dict] = None,
          capture: bool = True) -> dict:
    """Serve ``args.requests`` synthetic requests; returns the report.

    ``params`` replaces the seeded weights (the tests pass the reference's,
    through :func:`repro_torch.models.convert.params_from_reference`);
    ``capture=False`` decodes eagerly."""
    device = resolve_device(getattr(args, "device", "cuda"))
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    rng = np.random.default_rng(args.seed)
    if params is None:
        params = init_model(cfg, device, seed=args.seed)
    decode = make_decode(params, cfg, device, capture)

    lengths = rng.integers(args.min_prompt, args.max_prompt + 1,
                           args.requests)
    buckets = np.array([prefill_bucket(int(s)) for s in lengths])

    gen = np.zeros((args.requests, args.max_new), dtype=np.int64)
    finite = True
    t_prefill = t_decode = 0.0
    bucket_counts: dict = {}
    with torch.no_grad():
        for s_b in sorted(set(buckets.tolist())):
            idx = np.where(buckets == s_b)[0]
            bucket_counts[int(s_b)] = int(idx.size)
            tokens = rng.integers(1, cfg.vocab_size, (idx.size, s_b))
            batch = {"tokens": torch.as_tensor(tokens, dtype=torch.int32,
                                               device=device)}
            t0 = time.perf_counter()
            logits, cache, _ = prefill_step(params, cfg, batch)
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
            t_decode += time.perf_counter() - t1
            finite = finite and bool(torch.isfinite(logits).all())

    return {
        "arch": cfg.name, "requests": args.requests,
        "prompt_lengths": lengths.tolist(),
        "prefill_buckets": {str(k): v
                            for k, v in sorted(bucket_counts.items())},
        "prefill_compiles": 0,
        "decode_compiles": getattr(decode, "compiles", 0),
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
