"""The port's VLM family (phi-3-vision-4.2b) against the reference on the
same weights.

phi-3-vision-4.2b, reduced: 2 layers, d 256, 4 heads of 64 (H = Hkv),
SwiGLU d_ff 682, vocab 512, 8 patch tokens, f32. The reference
(``repro.models``) runs on CPU JAX under ``jax.jit``; its ``init_model``
weights reach the port through ``repro_torch.models.convert``. The
projected patch embeddings (the frontend's stub) and the tokens come from
numpy seeds; the patches replace the embeddings of the prompt's first 8
positions.

Tolerances, f32 from end to end (the packages differ by summation
order):

* prefill's logits and K/V cache at 1e-5 (abs + rel);
* 4 decode steps: the same greedy tokens, and the logits within 1e-4 of
  the largest reference logit;
* ``train_loss`` at 1e-4 relative and each gradient leaf at 1e-4 of its
  largest reference entry.

A prompt shorter than its patch tokens fails in the reference (its
concatenation lengthens the hidden states past the positions, a
broadcast error); the port raises ``ValueError`` naming
``num_patch_tokens`` there, in prefill, in training and in
``launch.serve``.
"""
import argparse
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import save_checkpoint              # noqa: E402
from repro_torch.configs import get_config                      # noqa: E402
from repro_torch.launch import serve as port_serve              # noqa: E402
from repro_torch.launch import train as port_train              # noqa: E402
from repro_torch.models import lm                               # noqa: E402
from repro_torch.models.convert import (params_from_reference,  # noqa: E402
                                        params_to_reference)
from repro_torch.models.inputs import make_batch                # noqa: E402
from repro_torch.tree import value_and_grad                     # noqa: E402

ARCH = "phi3_vision_4p2b"
TIGHT = dict(rtol=1e-5, atol=1e-5)
DECODE_TOL = 1e-4          # of the largest reference logit
GRAD_TOL = 1e-4            # loss relative; each leaf of its largest entry


@pytest.fixture(scope="module")
def ref():
    """The reference's modules (JAX on the CPU) and a memo of the model,
    its jitted functions and both packages' prefills."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.checkpoint import save_checkpoint as ref_save
    from repro.configs import get_config as ref_config
    from repro.launch import serve as ref_serve
    from repro.models import lm as ref_lm
    from repro.models.inputs import make_batch as ref_batch
    return argparse.Namespace(jax=jax, jnp=jnp, get_config=ref_config,
                              lm=ref_lm, make_batch=ref_batch, save=ref_save,
                              serve=ref_serve, memo={})


def _model(ref):
    """(reference cfg, port cfg, reference params, their numpy tree, port
    params, jitted reference prefill and decode), memoized."""
    if "model" not in ref.memo:
        rcfg, cfg = ref.get_config(ARCH).reduced(), get_config(ARCH).reduced()
        rp = ref.jax.jit(lambda k: ref.lm.init_model(k, rcfg))(
            ref.jax.random.PRNGKey(0))
        tree = ref.jax.tree.map(np.array, rp)
        prefill = ref.jax.jit(lambda p, b: ref.lm.prefill_step(p, rcfg, b))
        decode = ref.jax.jit(lambda p, t, c, n: ref.lm.serve_step(
            p, rcfg, t, c, n))
        ref.memo["model"] = (rcfg, cfg, rp, tree,
                             params_from_reference(tree, cfg, "cpu"),
                             prefill, decode)
    return ref.memo["model"]


def _close(got, expect, tol=TIGHT):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(expect, np.float32), **tol)


def _patches(cfg, b, seed):
    return np.random.default_rng(seed).normal(
        0, 0.02, (b, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32)


def _prefill(ref):
    """Both packages' prefill over a padded 24-token bucket of 2 rows, the
    first 8 positions the rows' patches: ``(reference (logits, cache),
    port (logits, cache))``, memoized."""
    if "prefill" not in ref.memo:
        rcfg, cfg, rp, _, params, prefill, _ = _model(ref)
        tokens = np.random.default_rng(3).integers(1, cfg.vocab_size, (2, 24))
        pe = _patches(cfg, 2, seed=4)
        rl, rc, _ = prefill(rp, {"tokens": ref.jnp.asarray(tokens,
                                                          ref.jnp.int32),
                                 "patch_embeds": ref.jnp.asarray(pe)})
        with torch.no_grad():
            logits, cache, _ = lm.prefill_step(
                params, cfg, {"tokens": torch.as_tensor(tokens,
                                                        dtype=torch.int32),
                              "patch_embeds": torch.as_tensor(pe)})
        ref.memo["prefill"] = ((rl, rc), (logits, cache))
    return ref.memo["prefill"]


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------
def test_prefill_logits_and_cache_match_reference(ref):
    """Prefill with the patches in place of the first 8 embeddings: the
    last position's logits and every layer's K/V, the patch positions'
    rows among them."""
    (rl, rc), (logits, cache) = _prefill(ref)
    assert _model(ref)[1].num_patch_tokens == 8
    _close(logits, rl)
    assert sorted(cache) == sorted(rc) == ["first_dense", "layers"]
    for n in ("k", "v"):
        _close(cache["layers"][n], rc["layers"][n])


def test_patches_move_the_prefill(ref):
    """The patches reach the model: the same tokens with other patches
    give other K/V at the patch positions (not past them in layer 0's
    keys, which see only their own position) and other logits."""
    _, cfg, _, _, params, _, _ = _model(ref)
    (_, _), (logits, cache) = _prefill(ref)
    tokens = np.random.default_rng(3).integers(1, cfg.vocab_size, (2, 24))
    with torch.no_grad():
        other, moved, _ = lm.prefill_step(
            params, cfg, {"tokens": torch.as_tensor(tokens,
                                                    dtype=torch.int32),
                          "patch_embeds": torch.as_tensor(
                              _patches(cfg, 2, seed=9))})
    k0, k1 = cache["layers"]["k"][0], moved["layers"]["k"][0]
    p = cfg.num_patch_tokens
    assert (k0[:, :p] != k1[:, :p]).all(dim=(2, 3)).all()
    assert torch.equal(k0[:, p:], k1[:, p:])
    assert not torch.allclose(logits, other)


def test_decode_matches_reference(ref):
    """Grow both prefill caches, then 4 decode steps, rows at their own
    lengths, each package fed its own greedy token: the same tokens,
    logits within ``DECODE_TOL`` of the largest; the caches after
    them."""
    rcfg, cfg, rp, _, params, _, decode = _model(ref)
    (rl, rc), (logits, cache) = _prefill(ref)
    rc = ref.lm.grow_cache(rc, 32)
    grown = lm.grow_cache(cache, 32)
    lengths = np.array([20, 24], np.int32)
    rtok = np.asarray(rl).argmax(-1)[:, None]
    tok = logits.argmax(-1)[:, None].numpy()
    for _ in range(4):
        assert (tok == rtok).all()
        rl, rc = decode(rp, ref.jnp.asarray(rtok, ref.jnp.int32), rc,
                        ref.jnp.asarray(lengths))
        with torch.no_grad():
            logits, _ = lm.serve_step(
                params, cfg, torch.as_tensor(tok, dtype=torch.int32), grown,
                torch.as_tensor(lengths))
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


def test_short_prompt_raises_value_error_where_the_reference_fails(ref):
    """16 patch tokens and an 8-token prompt: the reference's prefill
    fails on a broadcast; the port's prefill, train forward and
    ``launch.serve`` raise ``ValueError`` naming ``num_patch_tokens``."""
    rcfg = dataclasses.replace(ref.get_config(ARCH).reduced(),
                               num_patch_tokens=16)
    cfg = dataclasses.replace(get_config(ARCH).reduced(),
                              num_patch_tokens=16)
    _, _, rp, _, params, _, _ = _model(ref)
    tokens = np.random.default_rng(0).integers(1, cfg.vocab_size, (1, 8))
    pe = _patches(cfg, 1, seed=0)
    with pytest.raises(Exception) as failed:
        ref.lm.prefill_step(rp, rcfg, {
            "tokens": ref.jnp.asarray(tokens, ref.jnp.int32),
            "patch_embeds": ref.jnp.asarray(pe)})
    assert "broadcast" in str(failed.value)
    t, p = torch.as_tensor(tokens, dtype=torch.int32), torch.as_tensor(pe)
    with pytest.raises(ValueError, match="num_patch_tokens"):
        lm.prefill_step(params, cfg, {"tokens": t, "patch_embeds": p})
    with pytest.raises(ValueError, match="num_patch_tokens"):
        lm.model_hidden_train(params, cfg, t, patch_embeds=p)
    args = argparse.Namespace(arch=ARCH, reduced=True, requests=1,
                              min_prompt=8, max_prompt=8, max_new=2, seed=0,
                              device="cpu")
    with pytest.raises(ValueError, match="num_patch_tokens"):
        port_serve.serve(args, params=params, cfg=cfg)
    # at the patch count the prompt is served
    with torch.no_grad():
        logits, _, _ = lm.prefill_step(
            params, cfg, {"tokens": torch.zeros((1, 16), dtype=torch.int32),
                          "patch_embeds": p})
    assert torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# training, conversion, checkpoint
# ---------------------------------------------------------------------------
def test_train_loss_and_grads_match_reference(ref):
    """``train_loss`` on the reference's synthetic batch (2 x 40 tokens,
    the first 8 the patches and masked out of the loss) and every
    gradient leaf."""
    rcfg, cfg, rp, _, params, _, _ = _model(ref)
    rbatch = ref.make_batch(rcfg, 2, 40, seed=0)
    batch = make_batch(cfg, 2, 40, seed=0)
    np.testing.assert_array_equal(batch["patch_embeds"].numpy(),
                                  np.asarray(rbatch["patch_embeds"]))
    assert not batch["loss_mask"][:, :8].any()
    want_loss, want_grads = ref.jax.jit(ref.jax.value_and_grad(
        lambda p, b: ref.lm.train_loss(p, rcfg, b)))(rp, rbatch)
    loss, grads = value_and_grad(lambda p: lm.train_loss(p, cfg, batch),
                                 params)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=GRAD_TOL)
    got = ref.jax.tree.leaves(params_to_reference(grads, cfg))
    want = ref.jax.tree.leaves(want_grads)
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= GRAD_TOL * np.abs(w).max()


def test_params_and_checkpoint_round_trip(ref, tmp_path):
    """``params_to_reference(params_from_reference(t)) == t`` bit for bit,
    and the LM checkpoint writes the reference's files, bit for bit."""
    _, cfg, rp, tree, params, _, _ = _model(ref)
    back = params_to_reference(params, cfg)
    flat_t, def_t = ref.jax.tree_util.tree_flatten(tree)
    flat_b, def_b = ref.jax.tree_util.tree_flatten(back)
    assert def_t == def_b
    for a, b in zip(flat_t, flat_b, strict=True):
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    mine = save_checkpoint(str(tmp_path / "port"), 2, back)
    theirs = ref.save(str(tmp_path / "ref"), 2, rp)
    names = sorted(os.listdir(mine))
    assert names == sorted(os.listdir(theirs))
    for name in names:
        with open(os.path.join(mine, name), "rb") as a, \
                open(os.path.join(theirs, name), "rb") as b:
            assert a.read() == b.read(), name


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------
def test_serve_loop_matches_reference(ref):
    """``launch.serve`` at ``--reduced`` against the reference launcher:
    the same prompts, buckets and (on the reference's weights, patches
    drawn after each bucket's tokens) greedy tokens; one decode graph a
    bucket; the captured decode gives the eager decode's tokens."""
    args = argparse.Namespace(arch=ARCH, reduced=True, requests=3,
                              min_prompt=8, max_prompt=24, max_new=4, seed=0,
                              device="cpu")
    expect = ref.serve.serve(args)
    params = _model(ref)[4]
    got = port_serve.serve(args, params=params)
    for key in ("arch", "requests", "prompt_lengths", "prefill_buckets",
                "new_tokens", "finite", "sample_generation"):
        assert got[key] == expect[key], key
    assert got["decode_compiles"] == expect["decode_compiles"] \
        == len(got["prefill_buckets"]) > 1
    assert got["prefill_compiles"] == 0
    eager = port_serve.serve(args, params=params, capture=False)
    assert eager["sample_generation"] == got["sample_generation"]


def test_bucket_batch_draws_patches_after_the_tokens():
    """A bucket's batch: tokens, then ``num_patch_tokens`` patch
    embeddings a row from the same generator, in the config's dtype."""
    cfg = get_config(ARCH)
    batch = port_serve.bucket_batch(np.random.default_rng(2), cfg, 2, 1024,
                                    torch.device("cpu"))
    rng = np.random.default_rng(2)
    tokens = rng.integers(1, cfg.vocab_size, (2, 1024))
    patches = rng.normal(0, 0.02, (2, 576, cfg.d_model))
    assert sorted(batch) == ["patch_embeds", "tokens"]
    np.testing.assert_array_equal(batch["tokens"].numpy(), tokens)
    assert torch.equal(batch["patch_embeds"],
                       torch.as_tensor(patches, dtype=torch.bfloat16))


def test_train_cli_trains(ref):
    """``launch.train --workload lm --arch phi3_vision_4p2b --reduced``:
    one captured step (the patches copied in with the tokens), the loss
    falls over 4 steps."""
    args = port_train.parser().parse_args(
        ["--device", "cpu", "--workload", "lm", "--arch", ARCH, "--reduced",
         "--steps", "4", "--seq", "32"])
    rep, state = port_train.run_lm(args)
    assert rep["steps"] == len(rep["losses"]) == 4
    assert all(np.isfinite(rep["losses"]))
    assert rep["last_loss"] < rep["first_loss"]
    assert state["step"].compiles == 1
    assert tuple(state["batch"]["patch_embeds"].shape) == (4, 8, 256)
