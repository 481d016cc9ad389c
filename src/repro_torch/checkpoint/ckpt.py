"""Parameter-tree checkpoints in the reference package's layout.

    <dir>/step_<n:08d>/manifest.msgpack    {"treedef", "num", "step"}
    <dir>/step_<n:08d>/arr_<i>.npy         leaf i, in tree_leaves order

Leaves are written in :func:`repro_torch.tree.tree_leaves` order, which
is ``jax.tree.leaves`` order (dict keys sorted), and ``treedef`` is the
tree's structure printed as JAX prints a ``PyTreeDef``. For the same
values both packages write the same bytes, and each restores the other's
checkpoints.
"""
from __future__ import annotations

import os
import re
from typing import Any, Optional

import msgpack
import numpy as np
import torch

from repro_torch.tree import Tree, tree_leaves

__all__ = ["save_checkpoint", "latest_step", "restore_checkpoint",
           "treedef_str"]


def _treedef(tree: Tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{key!r}: {_treedef(tree[key])}"
                               for key in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef(t) for t in tree) + "]"
    if isinstance(tree, tuple):
        inner = ", ".join(_treedef(t) for t in tree)
        return "(" + inner + ("," if len(tree) == 1 else "") + ")"
    return "*"


def treedef_str(tree: Tree) -> str:
    """``str(jax.tree_util.tree_structure(tree))`` for a tree of dicts,
    lists and tuples, e.g. ``PyTreeDef({'b': *, 'w': [*, *]})``."""
    return f"PyTreeDef({_treedef(tree)})"


def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu().numpy()
    return np.asarray(leaf, order="C")


def save_checkpoint(directory: str, step: int, tree: Tree) -> str:
    """Write ``tree`` (tensors or arrays) as ``<directory>/step_<step>``;
    returns that path."""
    path = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    host = [_host(leaf) for leaf in tree_leaves(tree)]
    manifest = {"treedef": treedef_str(tree), "num": len(host), "step": step}
    for i, arr in enumerate(host):
        np.save(os.path.join(path, f"arr_{i}.npy"), arr)
    with open(os.path.join(path, "manifest.msgpack"), "wb") as f:
        f.write(msgpack.packb(manifest))
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, like: Tree,
                       step: Optional[int] = None) -> Tree:
    """Restore into the structure of ``like`` (leaf count and shapes
    checked); each leaf comes back on its ``like`` leaf's device and in
    its dtype. A bf16 leaf is stored as its raw bits (``np.load`` gives
    2-byte void) and read back as such. ``step`` defaults to the
    latest."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.msgpack"), "rb") as f:
        manifest = msgpack.unpackb(f.read())
    flat = tree_leaves(like)
    if manifest["num"] != len(flat):
        raise ValueError(f"checkpoint has {manifest['num']} leaves, "
                         f"expected {len(flat)}")
    loaded = []
    for i, ref in enumerate(flat):
        arr = np.load(os.path.join(path, f"arr_{i}.npy"))
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {i}: shape {arr.shape} != "
                             f"{tuple(ref.shape)}")
        if arr.dtype.kind == "V" and ref.dtype == torch.bfloat16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.as_tensor(arr)
        loaded.append(t.to(device=ref.device, dtype=ref.dtype))
    return _fill(like, iter(loaded))


def _fill(like: Tree, leaves) -> Tree:
    """``like``'s structure (dicts, lists, tuples) with the next leaves."""
    if isinstance(like, dict):
        return {key: _fill(like[key], leaves) for key in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_fill(sub, leaves) for sub in like)
    return next(leaves)
