"""The reference's LM parameters and caches, as the port's tensors.

The tests run both packages on the same weights: the reference's
``init_model`` tree, taken to numpy leaf by leaf, goes through
:func:`params_from_reference`. Its homogeneous stack is scan-stacked
(``layers`` leaves carry a leading L axis); the port keeps one dict per
layer, each leaf a view of one stacked tensor.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .config import ModelConfig
from .lm import check_supported


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


def _unstack(tree: Dict, i: int) -> Dict:
    return {k: _unstack(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def params_from_reference(tree: Dict, cfg: ModelConfig,
                          device: torch.device) -> Dict:
    """The reference's params (numpy leaves, scan-stacked ``layers``) as the
    port's (one dict per layer) on ``device``."""
    check_supported(cfg)
    params = _tree({k: v for k, v in tree.items() if k != "layers"}, device)
    stacked = _tree(tree["layers"], device)
    params["layers"] = [_unstack(stacked, i) for i in range(cfg.num_layers)]
    return params


def cache_from_reference(tree: Dict, device: torch.device) -> Dict:
    """The reference's decode cache (numpy leaves, ``layers`` k/v stacked
    ``[L, B, S, Hkv, Dh]``) as the port's, which has the same layout."""
    return {"first_dense": [], "layers": _tree(tree["layers"], device)}
