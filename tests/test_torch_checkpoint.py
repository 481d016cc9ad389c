"""``repro_torch.checkpoint`` against the reference's ``repro.checkpoint``.

For the same parameter values (seeded numpy, carried to each package as
its own arrays), both packages write byte-identical checkpoints: the
``manifest.msgpack`` (leaf count, step, and the treedef the port prints in
JAX's format) and every ``arr_<i>.npy``. Each package restores the other's
checkpoint with equal values, the port onto its ``like`` tree's devices
and dtypes. A wrong leaf count, a wrong shape and a missing directory
raise the same errors in both. ``latest_step`` agrees.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp                                         # noqa: E402

from repro import checkpoint as ref_ckpt                        # noqa: E402
from repro_torch import checkpoint as ckpt                      # noqa: E402
from repro_torch.checkpoint.ckpt import treedef_str             # noqa: E402
from repro_torch.tree import tree_leaves, tree_map              # noqa: E402


def _stacked_gnn(rng, kind, k=3, dims=(5, 8, 4), classes=3):
    layers = []
    for f_in, f_out in zip(dims[:-1], dims[1:]):
        names = ("w",) if kind == "gcn" else ("w_self", "w_neigh")
        layer = {n: rng.standard_normal((k, f_in, f_out)).astype(np.float32)
                 for n in names}
        layer["b"] = rng.standard_normal((k, f_out)).astype(np.float32)
        layers.append(layer)
    return {"body": {"layers": layers},
            "head": {"w": rng.standard_normal((k, dims[-1], classes))
                     .astype(np.float32),
                     "b": np.zeros((k, classes), np.float32)}}


def _tree(name):
    rng = np.random.default_rng(7)
    if name in ("gcn", "sage"):
        return _stacked_gnn(rng, name)
    if name == "classifier":
        return {key: rng.standard_normal(shape).astype(np.float32)
                for key, shape in (("w1", (4, 6)), ("b1", (6,)),
                                   ("w2", (6, 3)), ("b2", (3,)))}
    # dict keys out of order, int keys, nested lists and tuples, 0-d and
    # integer leaves (32-bit: JAX's default)
    return {"z": [rng.standard_normal(3).astype(np.float32),
                  (np.int32(4), rng.integers(0, 9, (2, 2), dtype=np.int32))],
            "a": {1: np.float32(2.5),
                  0: [rng.standard_normal((1, 2)).astype(np.float32)]},
            "m": (rng.standard_normal((5, 2)).astype(np.float32).T,)}


def _as_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_torch(v) for v in tree)
    return torch.as_tensor(np.asarray(tree))


TREES = ["gcn", "sage", "classifier", "nested"]


@pytest.mark.parametrize("name", TREES)
def test_treedef_string_is_jax_format(name):
    tree = _tree(name)
    assert treedef_str(_as_torch(tree)) == \
        str(jax.tree_util.tree_structure(_as_jax(tree)))


@pytest.mark.parametrize("name", TREES)
def test_checkpoint_files_are_byte_identical(tmp_path, name):
    tree = _tree(name)
    ref = ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 60,
                                   _as_jax(tree))
    mine = ckpt.save_checkpoint(str(tmp_path / "port"), 60, _as_torch(tree))
    assert os.path.basename(mine) == os.path.basename(ref) == "step_00000060"
    files = sorted(os.listdir(ref))
    assert files == sorted(os.listdir(mine))
    assert len(files) == len(jax.tree.leaves(_as_jax(tree))) + 1
    for f in files:
        with open(os.path.join(ref, f), "rb") as a, \
                open(os.path.join(mine, f), "rb") as b:
            assert a.read() == b.read(), f


@pytest.mark.parametrize("name", TREES)
def test_each_package_restores_the_others_checkpoint(tmp_path, name):
    tree = _tree(name)
    ckpt.save_checkpoint(str(tmp_path / "port"), 3, _as_torch(tree))
    ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 5, _as_jax(tree))
    want = [np.asarray(x) for x in jax.tree.leaves(_as_jax(tree))]

    theirs = ref_ckpt.restore_checkpoint(str(tmp_path / "port"),
                                         _as_jax(tree))
    for got, w in zip(jax.tree.leaves(theirs), want, strict=True):
        np.testing.assert_array_equal(np.asarray(got), w)

    like = _as_torch(jax.tree.map(np.zeros_like, tree))
    mine = ckpt.restore_checkpoint(str(tmp_path / "ref"), like)
    for got, ref, w in zip(tree_leaves(mine), tree_leaves(like), want,
                           strict=True):
        assert got.dtype == ref.dtype and got.device == ref.device
        np.testing.assert_array_equal(got.numpy(), w)
    assert treedef_str(mine) == treedef_str(like)


def test_restore_casts_to_the_like_dtype(tmp_path):
    tree = _as_torch(_tree("classifier"))
    ckpt.save_checkpoint(str(tmp_path), 1, tree)
    like = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float64),
                    tree)
    out = ckpt.restore_checkpoint(str(tmp_path), like)
    for got, want in zip(tree_leaves(out), tree_leaves(tree)):
        assert got.dtype == torch.float64
        assert torch.equal(got, want.double())


def _wrong_count(tree):
    return {**tree, "extra": np.zeros(2, np.float32)}


def _wrong_shape(tree):
    return {**tree, "w1": np.zeros((6, 4), np.float32)}


@pytest.mark.parametrize("edit,error", [(_wrong_count, ValueError),
                                        (_wrong_shape, ValueError),
                                        (None, FileNotFoundError)])
def test_bad_restores_raise_the_same_errors(tmp_path, edit, error):
    tree = _tree("classifier")
    saved = str(tmp_path / "saved")
    ref_ckpt.save_checkpoint(saved, 2, _as_jax(tree))
    where = saved if edit is not None else str(tmp_path / "empty")
    like = edit(tree) if edit is not None else tree
    with pytest.raises(error) as theirs:
        ref_ckpt.restore_checkpoint(where, _as_jax(like))
    with pytest.raises(error) as mine:
        ckpt.restore_checkpoint(where, _as_torch(like))
    assert str(mine.value) == str(theirs.value)


def test_latest_step_agrees(tmp_path):
    tree = _as_torch(_tree("classifier"))
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    assert ref_ckpt.latest_step(str(tmp_path / "none")) is None
    for step in (3, 12, 7):
        ckpt.save_checkpoint(str(tmp_path), step, tree)
    assert ckpt.latest_step(str(tmp_path)) == 12
    assert ref_ckpt.latest_step(str(tmp_path)) == 12
    out = ckpt.restore_checkpoint(str(tmp_path), tree, step=3)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(out),
                                                  tree_leaves(tree)))
