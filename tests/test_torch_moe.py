"""The port's mixture-of-experts layers and the MoE LM (qwen2-moe-a2.7b,
reduced: 2 layers, d 256, 4 experts top-2, 1 shared expert, f32) against
the reference on the same weights.

The reference (``repro.models.moe``, ``repro.models.lm``,
``repro.launch.serve``) runs on CPU JAX; its ``init_model`` weights,
taken to numpy, reach the port through
``repro_torch.models.convert.params_from_reference``. Inputs come from
numpy seeds.

Tolerances, f32 from end to end (the packages differ by summation order):

* ``moe_forward`` / ``moe_decode`` outputs and the aux loss at 1e-5 (abs
  + rel; measured below 1e-5 abs at outputs of order 1);
* ``train_loss`` at 1e-5 relative, each gradient leaf at 2e-5 of its
  largest reference entry, as the dense LM's tests hold them;
* prefill and decode logits at 1e-4 (abs + rel), as the dense LM's.

Drops are part of the function: the capacity is a Python int of the
padded length, slots go to every token's first choice before any second
choice, and a dropped token must be dropped in both packages. The
``capacity_factor = 0.05`` case gives each (row, expert) one slot.
"""
import argparse
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config                      # noqa: E402
from repro_torch.launch import serve as port_serve              # noqa: E402
from repro_torch.launch import train as port_train              # noqa: E402
from repro_torch.models import lm, moe                          # noqa: E402
from repro_torch.models.convert import (params_from_reference,  # noqa: E402
                                        params_to_reference)
from repro_torch.models.inputs import make_batch                # noqa: E402
from repro_torch.tree import value_and_grad                     # noqa: E402

ARCH = "qwen2_moe_a2p7b"
MOE_TOL = dict(rtol=1e-5, atol=1e-5)
F32 = dict(rtol=1e-4, atol=1e-4)
# per case: (config fields that shape the weights, fields that do not)
CASES = {"default": ({}, {}), "drops": ({}, {"capacity_factor": 0.05}),
         "padded_experts": ({"experts_pad_to": 6}, {})}


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as ref_config
    from repro.launch import serve as ref_serve
    from repro.models import lm as ref_lm
    from repro.models import moe as ref_moe
    from repro.models.inputs import make_batch as ref_batch
    return argparse.Namespace(jax=jax, jnp=jnp, get_config=ref_config,
                              serve=ref_serve, lm=ref_lm, moe=ref_moe,
                              make_batch=ref_batch, memo={})


def _model(ref, **extra):
    """(reference cfg, port cfg, reference params, their numpy tree, port
    params), memoized per config."""
    key = tuple(sorted(extra.items()))
    if key not in ref.memo:
        rcfg = dataclasses.replace(ref.get_config(ARCH).reduced(), **extra)
        cfg = dataclasses.replace(get_config(ARCH).reduced(), **extra)
        rp = ref.jax.jit(lambda key: ref.lm.init_model(key, rcfg))(
            ref.jax.random.PRNGKey(0))
        tree = ref.jax.tree.map(np.array, rp)
        ref.memo[key] = (rcfg, cfg, rp, tree,
                         params_from_reference(tree, cfg, "cpu"))
    return ref.memo[key]


def _close(got, expect, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(expect, np.float32), **tol)


def _case(ref, case):
    """(reference cfg, port cfg, reference layer 0's MoE params, the
    port's) for one of ``CASES``."""
    weights, rest = CASES[case]
    rcfg, cfg, rp, _, params = _model(ref, **weights)
    layer0 = ref.jax.tree.map(lambda a: a[0], rp["layers"])["ffn"]
    return (dataclasses.replace(rcfg, **rest),
            dataclasses.replace(cfg, **rest), layer0,
            params["layers"][0]["ffn"])


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_forward_matches_reference(ref, case):
    """Out and aux of one layer, ``[2, 40, d]`` tokens; with the drops
    case also unlike the same layer at a capacity that drops nothing."""
    rcfg, cfg, rp, p = _case(ref, case)
    x = np.random.default_rng(1).normal(size=(2, 40, cfg.d_model)) \
        .astype(np.float32)
    want, want_aux = ref.jax.jit(lambda p, x: ref.moe.moe_forward(
        p, rcfg, x))(rp, ref.jnp.asarray(x))
    got, aux = moe.moe_forward(p, cfg, torch.as_tensor(x))
    _close(got, want, MOE_TOL)
    _close(aux, want_aux, MOE_TOL)
    assert got.shape == x.shape and aux.dtype == torch.float32
    assert float(aux) > 0
    if case == "drops":
        full, _ = moe.moe_forward(
            p, dataclasses.replace(cfg, capacity_factor=8.0),
            torch.as_tensor(x))
        assert float((full - got).abs().max()) > 0.1


@pytest.mark.parametrize("case", ["default", "padded_experts"])
def test_moe_decode_matches_reference(ref, case):
    rcfg, cfg, rp, p = _case(ref, case)
    x = np.random.default_rng(2).normal(size=(3, 1, cfg.d_model)) \
        .astype(np.float32)
    want = ref.jax.jit(lambda p, x: ref.moe.moe_decode(p, rcfg, x))(
        rp, ref.jnp.asarray(x))
    got = moe.moe_decode(p, cfg, torch.as_tensor(x))
    _close(got, want, MOE_TOL)


# ---------------------------------------------------------------------------
# the model on the reference's weights
# ---------------------------------------------------------------------------
def test_train_loss_and_grads_match_reference(ref):
    """``train_loss`` (its aux term included) and every gradient leaf,
    the routers' and the shared experts' too, batch 2 x 40."""
    rcfg, cfg, rp, _, params = _model(ref)
    rbatch = ref.make_batch(rcfg, 2, 40, seed=0)
    batch = make_batch(cfg, 2, 40, seed=0)
    want_loss, want_grads = ref.jax.jit(ref.jax.value_and_grad(
        lambda p, b: ref.lm.train_loss(p, rcfg, b)))(rp, rbatch)
    loss, grads = value_and_grad(lambda p: lm.train_loss(p, cfg, batch),
                                 params)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    got = ref.jax.tree.leaves(params_to_reference(grads, cfg))
    want = ref.jax.tree.leaves(want_grads)
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 2e-5 * np.abs(w).max()
    _, aux = lm.model_hidden_train(params, cfg, batch["tokens"])
    assert float(aux) > 0


def test_prefill_and_decode_match_reference(ref):
    """Prefill over a padded 24-token bucket (the padding routed and
    taking capacity, as in the reference), then 6 decode steps, rows at
    their own lengths, the reference's greedy token fed to both."""
    rcfg, cfg, rp, _, params = _model(ref)
    tokens = np.random.default_rng(3).integers(1, 512, (2, 24))
    rl, rc, _ = ref.jax.jit(lambda p, b: ref.lm.prefill_step(p, rcfg, b))(
        rp, {"tokens": ref.jnp.asarray(tokens, ref.jnp.int32)})
    logits, cache, _ = lm.prefill_step(
        params, cfg, {"tokens": torch.as_tensor(tokens, dtype=torch.int32)})
    _close(logits, rl, F32)
    rc = ref.lm.grow_cache(rc, 32)
    cache = lm.grow_cache(cache, 32)
    decode = ref.jax.jit(lambda p, t, c, n: ref.lm.serve_step(p, rcfg, t, c,
                                                              n))
    nxt = np.asarray(rl).argmax(-1)[:, None]
    lengths = np.array([20, 24], np.int32)
    for _ in range(6):
        rl, rc = decode(rp, ref.jnp.asarray(nxt, ref.jnp.int32), rc,
                        ref.jnp.asarray(lengths))
        logits, cache = lm.serve_step(params, cfg,
                                      torch.as_tensor(nxt, dtype=torch.int32),
                                      cache, torch.as_tensor(lengths))
        _close(logits, rl, F32)
        nxt, lengths = np.asarray(rl).argmax(-1)[:, None], lengths + 1
    for n in ("k", "v"):
        _close(cache["layers"][n], rc["layers"][n], F32)


@pytest.mark.parametrize("extra", [{}, {"dtype": "bfloat16"}],
                         ids=["float32", "bfloat16"])
def test_params_round_trip_with_shared_experts(ref, extra):
    """``params_to_reference(params_from_reference(t)) == t`` bit for bit,
    the stacked ``shared`` list included; each port layer holds its own
    layer's shared expert, not the list indexed by the layer."""
    _, cfg, _, tree, _ = _model(ref, **extra)
    params = params_from_reference(tree, cfg, "cpu")
    shared = params["layers"][1]["ffn"]["shared"]
    assert isinstance(shared, list) and len(shared) == cfg.num_shared_experts
    assert shared[0]["w_up"].shape == (cfg.d_model, cfg.moe_d_ff)
    want = tree["layers"]["ffn"]["shared"][0]["w_up"][1]
    assert np.array_equal(moe_bits(shared[0]["w_up"]), want.view(np.uint8))
    back = params_to_reference(params, cfg)
    flat_t, def_t = ref.jax.tree_util.tree_flatten(tree)
    flat_b, def_b = ref.jax.tree_util.tree_flatten(back)
    assert def_t == def_b
    for a, b in zip(flat_t, flat_b, strict=True):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def moe_bits(t):
    """A tensor's bytes, as numpy ``uint8``."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().view(np.uint8)


def test_unported_moe_variants_raise():
    """Leading dense layers before the experts (deepseek's
    ``first_k_dense``) are laid out as the reference lays them out:
    ``params["first_dense"]`` holds them, dense, and ``layers`` the MoE
    layers after them; the cache keeps a list entry for each."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), first_k_dense=1,
                              d_ff=64)
    params = lm.init_model(cfg, "cpu")
    assert len(params["first_dense"]) == 1
    assert len(params["layers"]) == cfg.num_layers - 1
    assert "router" not in params["first_dense"][0]["ffn"]
    assert params["first_dense"][0]["ffn"]["w_up"].shape == (cfg.d_model,
                                                             64)
    assert len(lm.init_cache(cfg, 1, 8, "cpu")["first_dense"]) == 1
    assert "router" in lm.init_model(get_config(ARCH).reduced(),
                                     "cpu")["layers"][1]["ffn"]


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------
def test_serve_cli_runs_on_cpu(ref, capsys):
    """``launch.serve --arch qwen2_moe_a2p7b --reduced --device cpu``: one
    decode graph a bucket; on the reference's weights the captured decode
    (the CPU runs its plumbing) gives the eager decode's tokens."""
    port_serve.main(["--device", "cpu", "--arch", ARCH, "--reduced",
                     "--requests", "3", "--max-new", "4"])
    report = json.loads(capsys.readouterr().out)
    assert report["finite"] and report["arch"] == "qwen2-moe-a2.7b"
    assert report["decode_compiles"] == len(report["prefill_buckets"]) > 1
    args = port_serve.parser().parse_args(
        ["--device", "cpu", "--arch", ARCH, "--reduced", "--requests", "2",
         "--max-new", "4"])
    params = _model(ref)[4]
    runs = [port_serve.serve(args, params=params, capture=c)
            for c in (True, False)]
    assert runs[0]["sample_generation"] == runs[1]["sample_generation"]
    assert runs[1]["decode_compiles"] == 0


def test_train_cli_trains_and_checkpoints(ref, tmp_path):
    """``launch.train --workload lm --arch qwen2_moe_a2p7b --reduced``:
    3 steps, the loss falls, the aux loss is positive, and the checkpoint
    (the ``shared`` list included) restores in the reference bit for bit
    as the trained parameters."""
    from repro.checkpoint import restore_checkpoint
    args = port_train.parser().parse_args(
        ["--device", "cpu", "--workload", "lm", "--arch", ARCH, "--reduced",
         "--steps", "3", "--ckpt-dir", str(tmp_path)])
    rep, state = port_train.run_lm(args)
    assert rep["steps"] == len(rep["losses"]) == 3
    assert all(np.isfinite(rep["losses"]))
    assert rep["last_loss"] < rep["first_loss"]
    assert state["step"].compiles == 1
    cfg, params = state["cfg"], state["params"]
    _, aux = lm.model_hidden_train(params, cfg, state["batch"]["tokens"])
    assert float(aux) > 0
    _, _, rp, _, _ = _model(ref)
    restored = restore_checkpoint(str(tmp_path), rp)
    mine = params_to_reference(params, cfg)
    assert ref.jax.tree_util.tree_structure(restored) == \
        ref.jax.tree_util.tree_structure(mine)
    for got, want in zip(ref.jax.tree.leaves(restored),
                         ref.jax.tree.leaves(mine), strict=True):
        np.testing.assert_array_equal(got, want)
