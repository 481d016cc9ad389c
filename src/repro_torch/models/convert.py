"""The reference's LM parameters and caches, as the port's tensors.

The tests run both packages on the same weights: the reference's
``init_model`` tree, taken to numpy leaf by leaf, goes through
:func:`params_from_reference`. Its homogeneous stack is scan-stacked
(``layers`` leaves carry a leading L axis); the port keeps one dict per
layer, each leaf a view of one stacked tensor. An MoE layer's ``shared``
experts are a list in both layouts (in the reference's, a list of dicts
whose leaves are stacked over the layers). The leading dense layers of an
MoE stack (deepseek-v2's ``first_dense``) are a list of per-layer dicts
in both, params and cache, and carry over as they are; MLA's leaves
(``w_dq`` ... ``wo``; the cache's ``ckv``/``krope``) stack like any
other. :func:`params_to_reference`
goes back: the port's params as the reference's numpy tree, which the
tests compare with the reference's and the LM checkpoint stores.

An enc-dec model's ``encoder`` holds ``layers`` and ``final_norm``; its
layers are scan-stacked in the reference's homogeneous layout and carry
over as ``layers`` do, one dict a layer in the port. Its decode cache's
``memory`` (the encoder's output) carries over as it is.

A block pattern (xlstm, zamba2) is laid out per layer in both packages:
the reference's ``layers`` is already a list of per-layer dicts, ``{}`` at
each ``shared_attn`` position, beside a top-level ``shared_attn``, and its
cache is a list too. Those trees carry over leaf by leaf, as they are.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from .config import ModelConfig
from .lm import first_dense, per_layer


def tensor_from_numpy(x: Any, device: torch.device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``; bf16 arrays (numpy's
    ``bfloat16`` extension dtype) keep their bits."""
    x = np.array(x)                  # a writable, contiguous copy
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(x).to(device)


def _tree(x: Any, device: torch.device) -> Any:
    if isinstance(x, dict):
        return {k: _tree(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v, device) for v in x]
    return tensor_from_numpy(x, device)


def _unstack(tree: Any, i: int) -> Any:
    """Layer ``i`` of a stacked tree. A list stays a list (an MoE layer's
    ``shared`` experts, each of whose leaves is stacked): it is never
    indexed by the layer."""
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unstack(v, i) for v in tree]
    return tree[i]


def params_from_reference(tree: Dict, cfg: ModelConfig,
                          device: torch.device) -> Dict:
    """The reference's params (numpy leaves, scan-stacked ``layers`` and
    ``encoder.layers``, or per-layer ones for a block pattern) as the
    port's (one dict per layer) on ``device``."""
    if per_layer(cfg):
        return _tree(tree, device)
    params = _tree({k: v for k, v in tree.items()
                    if k not in ("layers", "encoder")}, device)
    stacked = _tree(tree["layers"], device)
    params["layers"] = [_unstack(stacked, i)
                        for i in range(cfg.num_layers - first_dense(cfg))]
    if "encoder" in tree:
        enc = _tree(tree["encoder"], device)
        enc["layers"] = [_unstack(enc["layers"], i)
                         for i in range(cfg.encoder_layers)]
        params["encoder"] = enc
    return params


def cache_from_reference(tree: Dict, device: torch.device) -> Dict:
    """The reference's decode cache (numpy leaves: ``layers`` k/v (MLA:
    ckv/krope) stacked ``[L, B, S, ...]`` beside the leading dense
    layers' ``first_dense`` list, or a per-layer list of K/V and block
    states; an enc-dec model's ``memory``) as the port's, which has the
    same layout."""
    return {k: _tree(v, device) for k, v in tree.items()
            if k in ("first_dense", "layers", "memory")}


def numpy_from_tensor(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array. numpy has no bf16 of its own: a
    bf16 tensor comes back as its raw bits, 2-byte void (``V2``), the
    dtype that ``np.load`` gives a bf16 array saved by either package."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _numpy_tree(x: Any) -> Any:
    if isinstance(x, dict):
        return {k: _numpy_tree(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_numpy_tree(v) for v in x]
    return numpy_from_tensor(x)


def _stack(layers: List[Any]) -> Any:
    """The inverse of :func:`_unstack`: per-layer trees of one structure
    as one tree whose leaves are stacked ``[L, ...]``; lists stay lists."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([lp[k] for lp in layers]) for k in first}
    if isinstance(first, list):
        return [_stack([lp[j] for lp in layers]) for j in range(len(first))]
    return np.stack(layers)


def params_to_reference(params: Dict, cfg: ModelConfig) -> Dict:
    """The port's params (one dict per layer) as the reference's: numpy
    leaves, ``layers`` and ``encoder.layers`` scan-stacked to ``[L,
    ...]`` (kept per layer for a block pattern). The inverse of
    :func:`params_from_reference`."""
    if per_layer(cfg):
        return _numpy_tree(params)
    tree = _numpy_tree({k: v for k, v in params.items()
                        if k not in ("layers", "encoder")})
    tree["layers"] = _stack([_numpy_tree(lp) for lp in params["layers"]])
    if "encoder" in params:
        enc = params["encoder"]
        tree["encoder"] = {
            "layers": _stack([_numpy_tree(lp) for lp in enc["layers"]]),
            "final_norm": _numpy_tree(enc["final_norm"])}
    return tree
