"""The port's MLA attention and deepseek-v2's LM (leading dense layers
before the experts) against the reference on the same weights.

deepseek-v2-236b, reduced: 2 layers (layer 0 dense, ``first_dense``;
layer 1 MoE: 4 experts top-2, 1 shared), d 256, 4 heads, q/kv LoRA
64/32, nope/rope/v 32/16/32, f32. The reference (``repro.models``) runs
on CPU JAX under ``jax.jit``; its ``init_model`` weights, taken to numpy,
reach the port through ``repro_torch.models.convert``. Inputs come from
numpy seeds; the LM has no dropout.

Tolerances, f32 from end to end (the packages differ by summation
order):

* ``mla_train``, prefill's logits and latent cache (``ckv``/``krope``,
  the ``first_dense`` entry's too) and the absorbed ``mla_decode``'s
  logits and cache over 4 steps at 1e-5 (abs + rel; measured below 8e-6
  abs at logits of order 3);
* ``train_loss`` at 1e-4 relative and each gradient leaf, ``first_dense``'s
  included, at 1e-4 of its largest reference entry;
* the leading dense layer without MLA (qwen2-moe reduced with
  ``first_k_dense=1`` and a dense layer of d_ff 128; the reduced config's
  ``d_ff`` is 0) at 1e-4, as the MoE family's tests hold logits.
"""
import argparse
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import (restore_checkpoint,         # noqa: E402
                                    save_checkpoint)
from repro_torch.configs import get_config                      # noqa: E402
from repro_torch.launch import serve as port_serve              # noqa: E402
from repro_torch.models import attention, lm                    # noqa: E402
from repro_torch.models.convert import (cache_from_reference,   # noqa: E402
                                        params_from_reference,
                                        params_to_reference)
from repro_torch.models.inputs import make_batch                # noqa: E402
from repro_torch.tree import tree_leaves, value_and_grad        # noqa: E402

ARCH = "deepseek_v2_236b"
TIGHT = dict(rtol=1e-5, atol=1e-5)
F32 = dict(rtol=1e-4, atol=1e-4)
LEADING_DENSE = ("qwen2_moe_a2p7b", {"first_k_dense": 1, "d_ff": 128})
MLA_LEAVES = ("w_dq", "w_uq", "w_dkv", "w_uk", "w_uv", "wo")


@pytest.fixture(scope="module")
def ref():
    """The reference's modules (JAX on the CPU) and a memo of models and
    jitted functions."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.checkpoint import restore_checkpoint as ref_restore
    from repro.checkpoint import save_checkpoint as ref_save
    from repro.configs import get_config as ref_config
    from repro.models import attention as ref_attention
    from repro.models import lm as ref_lm
    from repro.models.inputs import make_batch as ref_batch
    return argparse.Namespace(jax=jax, jnp=jnp, get_config=ref_config,
                              attention=ref_attention, lm=ref_lm,
                              make_batch=ref_batch, save=ref_save,
                              restore=ref_restore, memo={})


def _model(ref, arch=ARCH, **extra):
    """(reference cfg, port cfg, reference params, their numpy tree, port
    params, jitted reference prefill and decode), memoized."""
    key = (arch, tuple(sorted(extra.items())))
    if key not in ref.memo:
        rcfg = dataclasses.replace(ref.get_config(arch).reduced(), **extra)
        cfg = dataclasses.replace(get_config(arch).reduced(), **extra)
        rp = ref.jax.jit(lambda k: ref.lm.init_model(k, rcfg))(
            ref.jax.random.PRNGKey(0))
        tree = ref.jax.tree.map(np.array, rp)
        prefill = ref.jax.jit(lambda p, b: ref.lm.prefill_step(p, rcfg, b))
        decode = ref.jax.jit(lambda p, t, c, n: ref.lm.serve_step(
            p, rcfg, t, c, n))
        ref.memo[key] = (rcfg, cfg, rp, tree,
                         params_from_reference(tree, cfg, "cpu"), prefill,
                         decode)
    return ref.memo[key]


def _close(got, expect, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(expect, np.float32), **tol)


def _prefill(ref, arch=ARCH, **extra):
    """Both packages' prefill over a padded 24-token bucket of 2 rows:
    ``(reference (logits, cache), port (logits, cache))``, memoized."""
    key = ("prefill", arch, tuple(sorted(extra.items())))
    if key not in ref.memo:
        rcfg, cfg, rp, _, params, prefill, _ = _model(ref, arch, **extra)
        tokens = np.random.default_rng(3).integers(1, cfg.vocab_size, (2, 24))
        rl, rc, _ = prefill(rp, {"tokens": ref.jnp.asarray(tokens,
                                                          ref.jnp.int32)})
        logits, cache, _ = lm.prefill_step(
            params, cfg, {"tokens": torch.as_tensor(tokens,
                                                    dtype=torch.int32)})
        ref.memo[key] = ((rl, rc), (logits, cache))
    return ref.memo[key]


# ---------------------------------------------------------------------------
# MLA, layer by layer
# ---------------------------------------------------------------------------
def test_init_matches_reference_shapes_and_scales(ref):
    """Every leaf of the seeded init against ``jax.eval_shape`` of the
    reference's (``first_dense`` beside the stacked MoE layers), and each
    MLA matrix's spread against the reference's scale."""
    rcfg, cfg = ref.get_config(ARCH).reduced(), get_config(ARCH).reduced()
    rp = ref.jax.eval_shape(lambda: ref.lm.init_model(
        ref.jax.random.PRNGKey(0), rcfg))
    p = lm.init_model(cfg, "cpu", seed=5)
    assert len(p["first_dense"]) == 1 and len(p["layers"]) == 1
    assert "router" not in p["first_dense"][0]["ffn"]
    assert "router" in p["layers"][0]["ffn"]
    for path, leaf in ref.jax.tree_util.tree_flatten_with_path(rp)[0]:
        names = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        stacked = names[0] == "layers"
        got = p["layers"][0] if stacked else p
        for n in names[1:] if stacked else names:
            got = got[n]
        shape = (len(p["layers"]),) + tuple(got.shape) if stacked \
            else tuple(got.shape)
        assert shape == leaf.shape, names
        assert str(got.dtype).split(".")[-1] == leaf.dtype.name, names
    d, h = cfg.d_model, cfg.num_heads
    scales = {"w_dq": d, "w_uq": cfg.q_lora_rank, "w_dkv": d,
              "w_uk": cfg.kv_lora_rank, "w_uv": cfg.kv_lora_rank,
              "wo": h * cfg.v_head_dim}
    for layer in (p["first_dense"][0], p["layers"][0]):
        assert sorted(layer["attn"]) == sorted(MLA_LEAVES)
        for name, fan_in in scales.items():
            std = float(layer["attn"][name].std())
            assert abs(std - fan_in ** -0.5) < 0.1 * fan_in ** -0.5, name
    again = lm.init_model(cfg, "cpu", seed=5)
    assert torch.equal(p["first_dense"][0]["attn"]["w_uk"],
                       again["first_dense"][0]["attn"]["w_uk"])


def test_mla_train_matches_reference(ref):
    """``mla_train`` with ``return_kv`` on layer 0's weights, ``[2, 40,
    d]``: the output, the latent ``ckv`` and the roped shared key."""
    rcfg, cfg, rp, _, params, _, _ = _model(ref)
    x = np.random.default_rng(1).normal(size=(2, 40, cfg.d_model)) \
        .astype(np.float32)
    pos = np.arange(40)[None, :]
    want = ref.jax.jit(lambda p, x: ref.attention.mla_train(
        p, rcfg, x, ref.jnp.asarray(pos), return_kv=True))(
        rp["first_dense"][0]["attn"], ref.jnp.asarray(x))
    got = attention.mla_train(params["first_dense"][0]["attn"], cfg,
                              torch.as_tensor(x), torch.as_tensor(pos),
                              return_kv=True)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want, strict=True):
        _close(g, w, TIGHT)


def test_prefill_logits_and_latent_cache_match_reference(ref):
    (rl, rc), (logits, cache) = _prefill(ref)
    _close(logits, rl, TIGHT)
    assert set(cache["layers"]) == {"ckv", "krope"}
    for n in ("ckv", "krope"):
        _close(cache["layers"][n], rc["layers"][n], TIGHT)
        _close(cache["first_dense"][0][n], rc["first_dense"][0][n], TIGHT)


def test_absorbed_decode_matches_reference(ref):
    """Grow both prefill caches, then 4 absorbed decode steps, rows at
    their own lengths, the reference's greedy token fed to both; the
    latent caches after them, ``first_dense``'s included."""
    rcfg, cfg, rp, _, params, _, decode = _model(ref)
    (rl, rc), (_, cache) = _prefill(ref)
    rc = ref.lm.grow_cache(rc, 32)
    cache = lm.grow_cache(cache, 32)
    assert cache["first_dense"][0]["ckv"].shape[1] == 32
    nxt = np.asarray(rl).argmax(-1)[:, None]
    lengths = np.array([20, 24], np.int32)
    for _ in range(4):
        rl, rc = decode(rp, ref.jnp.asarray(nxt, ref.jnp.int32), rc,
                        ref.jnp.asarray(lengths))
        logits, out = lm.serve_step(params, cfg,
                                    torch.as_tensor(nxt, dtype=torch.int32),
                                    cache, torch.as_tensor(lengths))
        assert out is cache
        _close(logits, rl, TIGHT)
        nxt, lengths = np.asarray(rl).argmax(-1)[:, None], lengths + 1
    for n in ("ckv", "krope"):
        _close(cache["layers"][n], rc["layers"][n], TIGHT)
        _close(cache["first_dense"][0][n], rc["first_dense"][0][n], TIGHT)


def test_cache_init_and_reference_cache_carry_first_dense(ref):
    """``init_cache`` lays out the reference's tree; ``cache_from_reference``
    carries a reference cache whose ``first_dense`` is not empty, and the
    port decodes from it as from its own."""
    rcfg, cfg, rp, _, params, _, _ = _model(ref)
    rc = ref.lm.init_cache(rcfg, 2, 16)
    c = lm.init_cache(cfg, 2, 16, "cpu")
    assert len(c["first_dense"]) == len(rc["first_dense"]) == 1
    for n in ("ckv", "krope"):
        assert tuple(c["layers"][n].shape) == rc["layers"][n].shape
        assert tuple(c["first_dense"][0][n].shape) == \
            rc["first_dense"][0][n].shape
    (_, rcache), (_, cache) = _prefill(ref)
    moved = cache_from_reference(ref.jax.tree.map(np.array, rcache), "cpu")
    assert len(moved["first_dense"]) == 1
    moved, own = lm.grow_cache(moved, 28), lm.grow_cache(cache, 28)
    tok = torch.full((2, 1), 7, dtype=torch.int32)
    lens = torch.tensor([22, 24], dtype=torch.int32)
    a, _ = lm.serve_step(params, cfg, tok, moved, lens)
    b, _ = lm.serve_step(params, cfg, tok, own, lens)
    _close(a, b.numpy(), TIGHT)


# ---------------------------------------------------------------------------
# training, conversion, checkpoint
# ---------------------------------------------------------------------------
def test_train_loss_and_grads_match_reference(ref):
    """``train_loss`` (the MoE layer's aux term included) and every
    gradient leaf, the leading dense layer's MLA and FFN included, batch
    2 x 40."""
    rcfg, cfg, rp, _, params, _, _ = _model(ref)
    rbatch = ref.make_batch(rcfg, 2, 40, seed=0)
    batch = make_batch(cfg, 2, 40, seed=0)
    want_loss, want_grads = ref.jax.jit(ref.jax.value_and_grad(
        lambda p, b: ref.lm.train_loss(p, rcfg, b)))(rp, rbatch)
    loss, grads = value_and_grad(lambda p: lm.train_loss(p, cfg, batch),
                                 params)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    back = params_to_reference(grads, cfg)
    got = ref.jax.tree.leaves(back)
    want = ref.jax.tree.leaves(want_grads)
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()
    fd = back["first_dense"][0]
    assert all(np.abs(fd["attn"][n]).max() > 0 for n in MLA_LEAVES)
    assert np.abs(fd["ffn"]["w_gate"]).max() > 0


def test_remat_gives_the_same_loss_and_grads(ref):
    """``remat`` (per layer, ``first_dense``'s too) recomputes the same
    function: loss and gradients bitwise equal to the plain forward's."""
    _, cfg, _, _, params, _, _ = _model(ref)
    batch = make_batch(cfg, 2, 24, seed=1)
    runs = [value_and_grad(lambda p, c=c: lm.train_loss(p, c, batch), params)
            for c in (cfg, dataclasses.replace(cfg, remat=True))]
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(tree_leaves(runs[0][1]), tree_leaves(runs[1][1]),
                    strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("extra", [{}, {"dtype": "bfloat16"}],
                         ids=["float32", "bfloat16"])
def test_params_round_trip_bitwise(ref, extra):
    """``params_to_reference(params_from_reference(t)) == t`` bit for bit,
    ``first_dense`` and the MLA leaves included."""
    _, cfg, _, tree, _, _, _ = _model(ref, **extra)
    params = params_from_reference(tree, cfg, "cpu")
    assert len(params["layers"]) == cfg.num_layers - cfg.first_k_dense
    back = params_to_reference(params, cfg)
    flat_t, def_t = ref.jax.tree_util.tree_flatten(tree)
    flat_b, def_b = ref.jax.tree_util.tree_flatten(back)
    assert def_t == def_b
    for a, b in zip(flat_t, flat_b, strict=True):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_checkpoint_round_trip(ref, tmp_path):
    """The LM checkpoint stores deepseek's tree as the reference does: the
    same files, bit for bit, and each package restores the other's."""
    _, cfg, rp, tree, params, _, _ = _model(ref)
    mine = save_checkpoint(str(tmp_path / "port"), 3,
                           params_to_reference(params, cfg))
    theirs = ref.save(str(tmp_path / "ref"), 3, rp)
    names = sorted(os.listdir(mine))
    assert names == sorted(os.listdir(theirs))
    for name in names:
        with open(os.path.join(mine, name), "rb") as a, \
                open(os.path.join(theirs, name), "rb") as b:
            assert a.read() == b.read(), name
    restored = ref.restore(str(tmp_path / "port"), rp)
    for a, b in zip(ref.jax.tree.leaves(restored),
                    ref.jax.tree.leaves(tree), strict=True):
        np.testing.assert_array_equal(np.asarray(a), b)
    back = restore_checkpoint(str(tmp_path / "ref"), _tensors(tree))
    for a, b in zip(tree_leaves(back), ref.jax.tree.leaves(tree),
                    strict=True):
        np.testing.assert_array_equal(a.numpy(), b)


def _tensors(x):
    """A numpy tree as tensors: the ``like`` tree the port's restore
    takes, in the reference's layout."""
    if isinstance(x, dict):
        return {k: _tensors(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_tensors(v) for v in x]
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# the entry point, and leading dense layers without MLA
# ---------------------------------------------------------------------------
def test_serve_cli_runs_deepseek_on_cpu(ref, capsys):
    """``launch.serve --arch deepseek_v2_236b --reduced --device cpu``:
    one decode graph a bucket; on the reference's weights the captured
    decode (the CPU runs its plumbing) gives the eager decode's tokens."""
    port_serve.main(["--device", "cpu", "--arch", ARCH, "--reduced",
                     "--requests", "3", "--max-new", "4"])
    report = json.loads(capsys.readouterr().out)
    assert report["finite"] and report["arch"] == "deepseek-v2-236b"
    assert report["decode_compiles"] == len(report["prefill_buckets"]) > 1
    assert report["prefill_compiles"] == 0
    args = port_serve.parser().parse_args(
        ["--device", "cpu", "--arch", ARCH, "--reduced", "--requests", "2",
         "--max-new", "4"])
    params = _model(ref)[4]
    runs = [port_serve.serve(args, params=params, capture=c)
            for c in (True, False)]
    assert runs[0]["sample_generation"] == runs[1]["sample_generation"]
    assert runs[1]["decode_compiles"] == 0
    cut = dataclasses.replace(get_config(ARCH).reduced(), num_layers=3)
    report = port_serve.serve(args, cfg=cut)
    assert report["finite"] and report["decode_compiles"] >= 1


def test_leading_dense_layer_without_mla_matches_reference(ref):
    """qwen2-moe reduced with ``first_k_dense=1``: GQA attention, a dense
    layer 0 then one MoE layer; prefill, 3 decode steps and the training
    loss against the reference."""
    arch, extra = LEADING_DENSE
    rcfg, cfg, rp, _, params, _, decode = _model(ref, arch, **extra)
    assert "router" not in params["first_dense"][0]["ffn"]
    assert len(params["layers"]) == 1
    (rl, rc), (logits, cache) = _prefill(ref, arch, **extra)
    _close(logits, rl, F32)
    rc, cache = ref.lm.grow_cache(rc, 32), lm.grow_cache(cache, 32)
    nxt = np.asarray(rl).argmax(-1)[:, None]
    lengths = np.array([20, 24], np.int32)
    for _ in range(3):
        rl, rc = decode(rp, ref.jnp.asarray(nxt, ref.jnp.int32), rc,
                        ref.jnp.asarray(lengths))
        logits, cache = lm.serve_step(params, cfg,
                                      torch.as_tensor(nxt, dtype=torch.int32),
                                      cache, torch.as_tensor(lengths))
        _close(logits, rl, F32)
        nxt, lengths = np.asarray(rl).argmax(-1)[:, None], lengths + 1
    for n in ("k", "v"):
        _close(cache["first_dense"][0][n], rc["first_dense"][0][n], F32)
        _close(cache["layers"][n], rc["layers"][n], F32)
    batch = make_batch(cfg, 2, 24, seed=0)
    want = ref.jax.jit(lambda p, b: ref.lm.train_loss(p, rcfg, b))(
        rp, ref.make_batch(rcfg, 2, 24, seed=0))
    np.testing.assert_allclose(float(lm.train_loss(params, cfg, batch)),
                               float(want), rtol=1e-4)
