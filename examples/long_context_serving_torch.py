"""Long-context serving with recurrent state, on the PyTorch port (the
twin of ``examples/long_context_serving.py``): an xLSTM decodes with O(1)
state after consuming a long prompt, a zamba2 hybrid carries Mamba2
states, and a sliding-window dense model serves from a ring-buffer cache.

Each run prefills a 512-token prompt and decodes 32 tokens greedily, the
decode step one captured CUDA graph on the card
(``repro_torch.launch.serve.make_decode``). It runs on the GPU by default;
``--device cpu`` runs the plain PyTorch path.

    PYTHONPATH=src python examples/long_context_serving_torch.py
    PYTHONPATH=src python examples/long_context_serving_torch.py --device cpu
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device, synchronize
from repro_torch.launch.serve import make_decode
from repro_torch.models.lm import grow_cache, init_model, prefill_step
from repro_torch.tree import tree_leaves


def run_arch(name, cfg, device, prompt_len=512, new_tokens=32):
    rng = np.random.default_rng(0)
    params = init_model(cfg, device, seed=0)
    tokens = torch.as_tensor(rng.integers(1, cfg.vocab_size, (1, prompt_len)),
                             dtype=torch.int32, device=device)
    decode = make_decode(params, cfg, device)
    t0 = time.time()
    with torch.no_grad():
        logits, cache, lengths = prefill_step(params, cfg,
                                              {"tokens": tokens})
        cache = grow_cache(cache, prompt_len + new_tokens)
        nxt = logits.argmax(-1).to(torch.int32)[:, None]
        for _ in range(new_tokens):
            nxt, lengths, logits = decode(nxt, lengths, cache)
        finite = bool(torch.isfinite(logits).all())
    synchronize(device)
    dt = time.time() - t0
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(cache))
    print(f"{name:28s} prompt={prompt_len} +{new_tokens} tok: "
          f"{dt:5.1f}s  cache={cache_bytes/1e6:7.1f}MB  finite={finite}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    device = resolve_device(ap.parse_args(argv).device)
    # xLSTM: state is O(1) in sequence length
    run_arch("xlstm-125m (reduced)", get_config("xlstm_125m").reduced(),
             device)
    # zamba2 hybrid: mamba states + shared-attn ring buffer
    run_arch("zamba2-1.2b (reduced)", get_config("zamba2_1p2b").reduced(),
             device)
    # dense arch with sliding-window: ring buffer caps the cache
    cfg = dataclasses.replace(get_config("qwen3_4b").reduced(),
                              attention="sliding", window=128)
    run_arch("qwen3-4b (reduced, sw128)", cfg, device)


if __name__ == "__main__":
    main()
