"""The port's enc-dec family (seamless-m4t-large-v2) against the reference
on the same weights.

seamless-m4t-large-v2, reduced: 2 encoder and 2 decoder layers, d 256, 4
heads of 64 (H = Hkv), d_ff 2,048, GELU with biases, LayerNorm, vocab
512, f32. The reference (``repro.models``) runs on CPU JAX under
``jax.jit``; its ``init_model`` weights (the encoder's layers
scan-stacked, as the decoder's) reach the port through
``repro_torch.models.convert``. Inputs (tokens, the stub audio frames)
come from numpy seeds.

Tolerances, f32 from end to end (the packages differ by summation
order):

* cross-attention, the bidirectional encoder layer, ``_run_encoder``,
  prefill's logits, K/V cache and ``memory`` at 1e-5 (abs + rel);
* 4 decode steps: the same greedy tokens, and the logits within 1e-4 of
  the largest reference logit;
* ``train_loss`` at 1e-4 relative and each gradient leaf, the encoder's
  included, at 1e-4 of its largest reference entry.
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
from repro_torch.launch import train as port_train              # noqa: E402
from repro_torch.models import attention, lm                    # noqa: E402
from repro_torch.models.convert import (cache_from_reference,   # noqa: E402
                                        params_from_reference,
                                        params_to_reference)
from repro_torch.models.inputs import make_batch                # noqa: E402
from repro_torch.tree import tree_leaves, value_and_grad        # noqa: E402

ARCH = "seamless_m4t_large_v2"
TIGHT = dict(rtol=1e-5, atol=1e-5)
DECODE_TOL = 1e-4          # of the largest reference logit
GRAD_TOL = 1e-4            # loss relative; each leaf of its largest entry


@pytest.fixture(scope="module")
def ref():
    """The reference's modules (JAX on the CPU) and a memo of the model,
    its jitted functions and both packages' prefills."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.checkpoint import restore_checkpoint as ref_restore
    from repro.checkpoint import save_checkpoint as ref_save
    from repro.configs import get_config as ref_config
    from repro.launch import serve as ref_serve
    from repro.models import attention as ref_attention
    from repro.models import lm as ref_lm
    from repro.models.inputs import make_batch as ref_batch
    return argparse.Namespace(jax=jax, jnp=jnp, get_config=ref_config,
                              attention=ref_attention, lm=ref_lm,
                              make_batch=ref_batch, save=ref_save,
                              restore=ref_restore, serve=ref_serve, memo={})


def _model(ref, **extra):
    """(reference cfg, port cfg, reference params, their numpy tree, port
    params, jitted reference prefill and decode), memoized."""
    key = tuple(sorted(extra.items()))
    if key not in ref.memo:
        rcfg = dataclasses.replace(ref.get_config(ARCH).reduced(), **extra)
        cfg = dataclasses.replace(get_config(ARCH).reduced(), **extra)
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


def _close(got, expect, tol=TIGHT):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(expect, np.float32), **tol)


def _frames(cfg, b, se, seed):
    return np.random.default_rng(seed).normal(
        0, 0.02, (b, se, cfg.d_model)).astype(np.float32)


def _prefill(ref):
    """Both packages' prefill over a padded 24-token bucket of 2 rows and
    8 frames a row: ``(reference (logits, cache), port (logits,
    cache))``, memoized."""
    if "prefill" not in ref.memo:
        rcfg, cfg, rp, _, params, prefill, _ = _model(ref)
        tokens = np.random.default_rng(3).integers(1, cfg.vocab_size, (2, 24))
        frames = _frames(cfg, 2, 8, seed=4)
        rl, rc, _ = prefill(rp, {"tokens": ref.jnp.asarray(tokens,
                                                          ref.jnp.int32),
                                 "frames": ref.jnp.asarray(frames)})
        with torch.no_grad():
            logits, cache, _ = lm.prefill_step(
                params, cfg, {"tokens": torch.as_tensor(tokens,
                                                        dtype=torch.int32),
                              "frames": torch.as_tensor(frames)})
        ref.memo["prefill"] = ((rl, rc), (logits, cache))
    return ref.memo["prefill"]


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------
def test_init_matches_reference_structure(ref):
    """The seeded init's tree against ``jax.eval_shape`` of the
    reference's: every decoder layer holds ``ln_cross`` and ``cross``, the
    encoder its layers (one dict each, stacked in the reference) and
    ``final_norm``."""
    rcfg, cfg = ref.get_config(ARCH).reduced(), get_config(ARCH).reduced()
    shapes = ref.jax.eval_shape(lambda: ref.lm.init_model(
        ref.jax.random.PRNGKey(0), rcfg))
    params = lm.init_model(cfg, "cpu", seed=1)
    assert len(params["encoder"]["layers"]) == cfg.encoder_layers == 2
    assert sorted(params["layers"][0]) == ["attn", "cross", "ffn", "ln1",
                                           "ln2", "ln_cross"]
    assert sorted(params["encoder"]["layers"][0]) == ["attn", "ffn", "ln1",
                                                      "ln2"]
    mine = params_to_reference(params, cfg)
    assert ref.jax.tree_util.tree_structure(mine) == \
        ref.jax.tree_util.tree_structure(shapes)
    for a, b in zip(ref.jax.tree.leaves(mine), ref.jax.tree.leaves(shapes),
                    strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_cross_attention_matches_reference(ref):
    """``cross_attention_train`` on layer 0's cross weights: 10 queries
    over a 12-long memory, no mask, no RoPE."""
    rcfg, cfg, rp, _, params, _, _ = _model(ref)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 10, cfg.d_model)).astype(np.float32)
    mem = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    cross = ref.jax.tree.map(lambda t: t[0], rp["layers"]["cross"])
    want = ref.attention.cross_attention_train(
        cross, rcfg, ref.jnp.asarray(x), ref.jnp.asarray(mem))
    got = attention.cross_attention_train(params["layers"][0]["cross"], cfg,
                                          torch.as_tensor(x),
                                          torch.as_tensor(mem))
    assert tuple(got.shape) == (2, 10, cfg.d_model)
    _close(got, want)


def test_encoder_self_attention_is_bidirectional(ref):
    """``attention_train(causal=False)`` (an encoder layer's) against the
    reference's, and the causal default differs from it on every
    position but the last."""
    rcfg, cfg, rp, _, params, _, _ = _model(ref)
    x = np.random.default_rng(2).normal(size=(2, 9, cfg.d_model)) \
        .astype(np.float32)
    pos = np.arange(9)[None, :]
    attn = ref.jax.tree.map(lambda t: t[0], rp["encoder"]["layers"]["attn"])
    p = params["encoder"]["layers"][0]["attn"]
    want = ref.jax.jit(lambda p, x: ref.attention.attention_train(
        p, rcfg, x, ref.jnp.asarray(pos), causal=False))(
        attn, ref.jnp.asarray(x))
    got = attention.attention_train(p, cfg, torch.as_tensor(x),
                                    torch.as_tensor(pos), causal=False)
    _close(got, want)
    causal = attention.attention_train(p, cfg, torch.as_tensor(x),
                                       torch.as_tensor(pos))
    differs = (causal - got).abs().amax(dim=(0, 2)) > 1e-6
    assert differs[:-1].all() and not differs[-1]


def test_run_encoder_matches_reference(ref):
    """The whole encoder (2 bidirectional layers, final norm) over 8
    frames: the decoder's memory."""
    rcfg, cfg, rp, _, params, _, _ = _model(ref)
    frames = _frames(cfg, 2, 8, seed=5)
    want = ref.jax.jit(lambda p, f: ref.lm._run_encoder(p, rcfg, f))(
        rp, ref.jnp.asarray(frames))
    got = lm._run_encoder(params, cfg, torch.as_tensor(frames))
    assert tuple(got.shape) == (2, 8, cfg.d_model)
    _close(got, want)


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------
def test_prefill_logits_cache_and_memory_match_reference(ref):
    (rl, rc), (logits, cache) = _prefill(ref)
    _close(logits, rl)
    assert sorted(cache) == sorted(rc) == ["first_dense", "layers", "memory"]
    for n in ("k", "v"):
        _close(cache["layers"][n], rc["layers"][n])
    _close(cache["memory"], rc["memory"])


def test_decode_matches_reference(ref):
    """Grow both prefill caches (memory untouched), then 4 decode steps,
    rows at their own lengths, each package fed its own greedy token: the
    same tokens, logits within ``DECODE_TOL`` of the largest; the caches
    after them."""
    rcfg, cfg, rp, _, params, _, decode = _model(ref)
    (rl, rc), (logits, cache) = _prefill(ref)
    rc = ref.lm.grow_cache(rc, 32)
    grown = lm.grow_cache(cache, 32)
    assert grown["memory"] is cache["memory"]
    lengths = np.array([20, 24], np.int32)
    rtok = np.asarray(rl).argmax(-1)[:, None]
    tok = logits.argmax(-1)[:, None].numpy()
    for _ in range(4):
        assert (tok == rtok).all()
        rl, rc = decode(rp, ref.jnp.asarray(rtok, ref.jnp.int32), rc,
                        ref.jnp.asarray(lengths))
        with torch.no_grad():
            logits, out = lm.serve_step(
                params, cfg, torch.as_tensor(tok, dtype=torch.int32), grown,
                torch.as_tensor(lengths))
        assert out is grown
        want = np.array(rl)
        assert float((logits - torch.from_numpy(want)).abs().max()) \
            <= DECODE_TOL * float(np.abs(want).max())
        rtok = want.argmax(-1)[:, None]
        tok = logits.argmax(-1)[:, None].numpy()
        lengths = lengths + 1
    assert (tok == rtok).all()
    for n in ("k", "v"):
        _close(grown["layers"][n], rc["layers"][n], dict(rtol=1e-4,
                                                         atol=1e-4))
    _close(grown["memory"], rc["memory"])


def test_cache_init_and_reference_cache_carry_memory(ref):
    """``init_cache(enc_len=)`` lays out the reference's tree with a zero
    memory; ``cache_from_reference`` keeps the reference's memory, and
    the port decodes from it as from its own."""
    rcfg, cfg, rp, _, params, _, _ = _model(ref)
    rc = ref.lm.init_cache(rcfg, 2, 16, enc_len=8)
    c = lm.init_cache(cfg, 2, 16, "cpu", enc_len=8)
    assert sorted(c) == sorted(rc)
    assert tuple(c["memory"].shape) == rc["memory"].shape == (2, 8, 256)
    assert not c["memory"].any()
    (_, rcache), (_, cache) = _prefill(ref)
    moved = cache_from_reference(ref.jax.tree.map(np.array, rcache), "cpu")
    assert sorted(moved) == ["first_dense", "layers", "memory"]
    moved, own = lm.grow_cache(moved, 28), lm.grow_cache(cache, 28)
    tok = torch.full((2, 1), 7, dtype=torch.int32)
    lens = torch.tensor([22, 24], dtype=torch.int32)
    with torch.no_grad():
        a, _ = lm.serve_step(params, cfg, tok, moved, lens)
        b, _ = lm.serve_step(params, cfg, tok, own, lens)
    _close(a, b.numpy())


# ---------------------------------------------------------------------------
# training, conversion, checkpoint
# ---------------------------------------------------------------------------
def test_train_loss_and_grads_match_reference(ref):
    """``train_loss`` on the reference's synthetic batch (2 x 40 tokens,
    8 frames a row) and every gradient leaf, the encoder's included."""
    rcfg, cfg, rp, _, params, _, _ = _model(ref)
    rbatch = ref.make_batch(rcfg, 2, 40, seed=0)
    batch = make_batch(cfg, 2, 40, seed=0)
    np.testing.assert_array_equal(batch["frames"].numpy(),
                                  np.asarray(rbatch["frames"]))
    want_loss, want_grads = ref.jax.jit(ref.jax.value_and_grad(
        lambda p, b: ref.lm.train_loss(p, rcfg, b)))(rp, rbatch)
    loss, grads = value_and_grad(lambda p: lm.train_loss(p, cfg, batch),
                                 params)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=GRAD_TOL)
    back = params_to_reference(grads, cfg)
    got, want = ref.jax.tree.leaves(back), ref.jax.tree.leaves(want_grads)
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= GRAD_TOL * np.abs(w).max()
    enc = back["encoder"]["layers"]
    assert all(np.abs(enc["attn"][n]).max() > 0 for n in ("wq", "wk", "wv"))
    assert np.abs(back["layers"]["cross"]["wk"]).max() > 0


def test_remat_gives_the_same_loss_and_grads(ref):
    """``remat`` (per layer, the encoder's too) recomputes the same
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
    the stacked encoder included."""
    _, cfg, _, tree, _, _, _ = _model(ref, **extra)
    params = params_from_reference(tree, cfg, "cpu")
    assert len(params["encoder"]["layers"]) == cfg.encoder_layers
    back = params_to_reference(params, cfg)
    flat_t, def_t = ref.jax.tree_util.tree_flatten(tree)
    flat_b, def_b = ref.jax.tree_util.tree_flatten(back)
    assert def_t == def_b
    for a, b in zip(flat_t, flat_b, strict=True):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_checkpoint_round_trip(ref, tmp_path):
    """The LM checkpoint stores seamless's tree (the encoder subtree
    included) as the reference does: the same files, bit for bit, and
    each package restores the other's."""
    _, cfg, rp, tree, params, _, _ = _model(ref)
    mine = save_checkpoint(str(tmp_path / "port"), 3,
                           params_to_reference(params, cfg))
    theirs = ref.save(str(tmp_path / "ref"), 3, rp)
    names = sorted(os.listdir(mine))
    assert names == sorted(os.listdir(theirs))
    with open(os.path.join(mine, "manifest.msgpack"), "rb") as f:
        assert b"encoder" in f.read()
    for name in names:
        with open(os.path.join(mine, name), "rb") as a, \
                open(os.path.join(theirs, name), "rb") as b:
            assert a.read() == b.read(), name
    restored = ref.restore(str(tmp_path / "port"), rp)
    for a, b in zip(ref.jax.tree.leaves(restored),
                    ref.jax.tree.leaves(tree), strict=True):
        np.testing.assert_array_equal(np.asarray(a), b)
    like = params_to_reference(params, cfg)
    back = restore_checkpoint(str(tmp_path / "ref"), _tensors(like))
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
# the entry points
# ---------------------------------------------------------------------------
def test_serve_loop_matches_reference(ref):
    """``launch.serve`` at ``--reduced`` against the reference launcher:
    the same prompts, buckets and (on the reference's weights, frames
    drawn after each bucket's tokens) greedy tokens; one decode graph a
    bucket; the captured decode (the CPU runs its plumbing) gives the
    eager decode's tokens."""
    args = argparse.Namespace(arch=ARCH, reduced=True, requests=2,
                              min_prompt=6, max_prompt=20, max_new=3, seed=0,
                              device="cpu")
    expect = ref.serve.serve(args)
    rcfg = ref.get_config(ARCH).reduced()
    tree = ref.jax.tree.map(np.array, ref.lm.init_model(
        ref.jax.random.PRNGKey(args.seed), rcfg))
    params = params_from_reference(tree, get_config(ARCH).reduced(), "cpu")
    got = port_serve.serve(args, params=params)
    for key in ("arch", "requests", "prompt_lengths", "prefill_buckets",
                "new_tokens", "finite", "sample_generation"):
        assert got[key] == expect[key], key
    assert got["decode_compiles"] == expect["decode_compiles"] \
        == len(got["prefill_buckets"]) > 1
    assert got["prefill_compiles"] == 0
    eager = port_serve.serve(args, params=params, capture=False)
    assert eager["sample_generation"] == got["sample_generation"]
    assert eager["decode_compiles"] == 0


def test_bucket_batch_draws_frames_after_the_tokens():
    """A bucket's batch: tokens, then ``max(8, bucket // 8)`` frames a row
    from the same generator, in the config's dtype."""
    cfg = get_config(ARCH)
    batch = port_serve.bucket_batch(np.random.default_rng(0), cfg, 3, 128,
                                    torch.device("cpu"))
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, cfg.vocab_size, (3, 128))
    frames = rng.normal(0, 0.02, (3, 16, cfg.d_model))
    assert sorted(batch) == ["frames", "tokens"]
    np.testing.assert_array_equal(batch["tokens"].numpy(), tokens)
    assert batch["frames"].dtype == torch.bfloat16
    assert torch.equal(batch["frames"],
                       torch.as_tensor(frames, dtype=torch.bfloat16))


def test_train_cli_trains_and_checkpoints(ref, tmp_path):
    """``launch.train --workload lm --arch seamless_m4t_large_v2
    --reduced``: one captured step (the frames copied in with the
    tokens), the loss falls over 4 steps, and the checkpoint restores in
    the reference bit for bit as the trained parameters."""
    from repro.checkpoint import restore_checkpoint as ref_restore
    args = port_train.parser().parse_args(
        ["--device", "cpu", "--workload", "lm", "--arch", ARCH, "--reduced",
         "--steps", "4", "--seq", "32", "--ckpt-dir", str(tmp_path)])
    rep, state = port_train.run_lm(args)
    assert rep["steps"] == len(rep["losses"]) == 4
    assert all(np.isfinite(rep["losses"]))
    assert rep["last_loss"] < rep["first_loss"]
    assert state["step"].compiles == 1
    assert tuple(state["batch"]["frames"].shape) == (4, 8, 256)
    _, _, rp, _, _, _, _ = _model(ref)
    mine = params_to_reference(state["params"], state["cfg"])
    restored = ref_restore(str(tmp_path), rp)
    for got, want in zip(ref.jax.tree.leaves(restored),
                         ref.jax.tree.leaves(mine), strict=True):
        np.testing.assert_array_equal(got, want)


def test_serve_cli_runs_on_cpu(capsys):
    port_serve.main(["--device", "cpu", "--arch", ARCH, "--reduced",
                     "--requests", "2", "--max-new", "3"])
    report = json.loads(capsys.readouterr().out)
    assert report["finite"] and report["arch"] == "seamless-m4t-large-v2"
    assert report["decode_compiles"] == len(report["prefill_buckets"])
