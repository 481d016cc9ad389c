"""The port's dense LM (prefill, KV cache, decode, serve loop) against the
reference on the same weights.

The reference (``repro.models``, ``repro.launch.serve``) runs on CPU JAX
under ``jax.jit``, its flash-decode branch through the Pallas kernel in
interpret mode. Its ``init_model`` weights, taken to numpy, reach the port
through ``repro_torch.models.convert.params_from_reference``. Inputs come
from numpy seeds.

Tolerances: f32 logits and caches at 1e-4 (abs + rel); both packages
compute in f32 from end to end and differ by summation order (measured
below 1e-5). The bf16 case holds logits at 2e-2 relative to the largest
reference logit plus 2e-2 of each: XLA on the CPU and PyTorch round bf16
intermediates at other places (XLA fuses elementwise chains in f32), so
over two layers single logits differ by up to ~0.04 at a largest logit of
~3.4 (rms difference ~0.011), more than 2e-2 of a small logit.
"""
import argparse
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as port_configs                 # noqa: E402
from repro_torch.launch import serve as port_serve              # noqa: E402
from repro_torch.models import inputs as port_inputs            # noqa: E402
from repro_torch.models import layers as port_layers            # noqa: E402
from repro_torch.models import lm                               # noqa: E402
from repro_torch.models.convert import (cache_from_reference,   # noqa: E402
                                        params_from_reference)

F32 = dict(rtol=1e-4, atol=1e-4)
ARCHS = {
    "qwen3_4b": ("qwen3_4b", {}),
    "qwen3_4b_gqa": ("qwen3_4b", {"num_kv_heads": 2}),
    "glm4_9b": ("glm4_9b", {}),
    "qwen15_4b": ("qwen15_4b", {}),
}
PROMPT, GROW, STEPS = 24, 40, 8


@pytest.fixture(scope="module")
def ref():
    """The reference's modules (JAX on the CPU) and a memo of jitted
    prefill/decode functions and converted models."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.launch import serve as serve_mod
    from repro.models import init_cache, init_model, serve_step
    from repro.models import inputs as ref_inputs
    from repro.models import layers as ref_layers
    from repro.models.lm import grow_cache, prefill_step
    return argparse.Namespace(
        jax=jax, jnp=jnp, get_config=get_config, serve=serve_mod,
        init_model=init_model, init_cache=init_cache, serve_step=serve_step,
        prefill_step=prefill_step, grow_cache=grow_cache, inputs=ref_inputs,
        layers=ref_layers, memo={})


def _model(ref, arch, **extra):
    """(reference cfg, port cfg, reference params, port params, jitted
    reference prefill and decode) for a reduced arch with ``extra``."""
    key = (arch, tuple(sorted(extra.items())))
    if key not in ref.memo:
        rcfg = dataclasses.replace(ref.get_config(arch).reduced(), **extra)
        cfg = dataclasses.replace(port_configs.get_config(arch).reduced(),
                                  **extra)
        rp = ref.init_model(ref.jax.random.PRNGKey(0), rcfg)
        tree = ref.jax.tree.map(lambda x: np.array(x), rp)
        decode = {fd: ref.jax.jit(
            lambda p, t, c, n, fd=fd: ref.serve_step(
                p, dataclasses.replace(rcfg, use_flash_decode=fd), t, c, n))
            for fd in (False, True)}
        ref.memo[key] = (rcfg, cfg, rp, params_from_reference(tree, cfg,
                                                              "cpu"),
                         ref.jax.jit(lambda p, b: ref.prefill_step(p, rcfg,
                                                                   b)),
                         decode)
    return ref.memo[key]


def _close(got, expect, tol=F32):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(expect, np.float32), **tol)


def _prefill_both(ref, model, tokens):
    rcfg, cfg, rp, p, prefill, _ = model
    rl, rc, rlen = prefill(rp, {"tokens": ref.jnp.asarray(tokens,
                                                           ref.jnp.int32)})
    logits, cache, lengths = lm.prefill_step(
        p, cfg, {"tokens": torch.as_tensor(tokens, dtype=torch.int32)})
    return (rl, rc, rlen), (logits, cache, lengths)


def _decode_both(ref, model, rc, cache, tokens, lengths, flash, tol=F32,
                 steps=STEPS):
    """``steps`` decode steps on both packages from the same state, the
    reference's greedy token fed to both; each step's logits held."""
    rcfg, cfg, rp, p, _, decode = model
    for _ in range(steps):
        rl, rc = decode[flash](rp, ref.jnp.asarray(tokens, ref.jnp.int32),
                               rc, ref.jnp.asarray(lengths, ref.jnp.int32))
        logits, cache = lm.serve_step(
            p, cfg, torch.as_tensor(tokens, dtype=torch.int32), cache,
            torch.as_tensor(lengths, dtype=torch.int32))
        _close(logits, rl, tol)
        tokens = np.asarray(rl).argmax(-1)[:, None]
        lengths = lengths + 1
    return rc, cache


# ---------------------------------------------------------------------------
# configs, inputs, layers
# ---------------------------------------------------------------------------
def test_configs_match_reference(ref):
    from repro.configs import ALIASES, ARCH_IDS
    assert port_configs.ARCH_IDS == ARCH_IDS
    assert port_configs.ALIASES == ALIASES
    for arch in ARCH_IDS + sorted(ALIASES):
        mine, theirs = port_configs.get_config(arch), ref.get_config(arch)
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert dataclasses.asdict(mine.reduced()) == \
            dataclasses.asdict(theirs.reduced())
        assert mine.param_count() == theirs.param_count()
        assert mine.active_param_count() == theirs.active_param_count()
        assert mine.blocks == theirs.blocks
        assert mine.group_size == theirs.group_size
    with pytest.raises(KeyError):
        port_configs.get_config("no-such-arch")


def test_inputs_match_reference(ref):
    assert {k: dataclasses.astuple(v) for k, v in port_inputs.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in ref.inputs.SHAPES.items()}
    for arch in port_configs.ARCH_IDS:
        for shape in port_inputs.SHAPES:
            mine = port_inputs.effective_config(
                port_configs.get_config(arch), shape)
            theirs = ref.inputs.effective_config(ref.get_config(arch), shape)
            assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    for arch in ("qwen3_4b", "phi3_vision_4p2b", "seamless_m4t_large_v2"):
        rcfg = ref.get_config(arch).reduced()
        cfg = port_configs.get_config(arch).reduced()
        expect = ref.inputs.make_batch(rcfg, 2, 16, seed=3)
        got = port_inputs.make_batch(cfg, 2, 16, seed=3)
        assert sorted(got) == sorted(expect)
        for name in got:
            _close(got[name], expect[name], dict(rtol=0, atol=0))


@pytest.mark.parametrize("arch", ["nemotron4_340b", "seamless_m4t_large_v2"])
def test_norm_and_ffn_variants_match_reference(ref, arch):
    """layernorm, squared-relu and gelu FFNs (with bias), on the reference's
    weights."""
    rcfg = ref.get_config(arch).reduced()
    cfg = port_configs.get_config(arch).reduced()
    key = ref.jax.random.PRNGKey(1)
    rp = ref.layers.init_ffn(key, rcfg)
    rng = np.random.default_rng(2)
    rp = {k: ref.jnp.asarray(rng.normal(size=v.shape) * 0.1, v.dtype)
          for k, v in rp.items()}                     # nonzero biases too
    p = {k: torch.as_tensor(np.array(v)) for k, v in rp.items()}
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    _close(port_layers.ffn_forward(p, cfg, torch.as_tensor(x)),
           ref.layers.ffn_forward(rp, rcfg, ref.jnp.asarray(x)))
    norm = {"scale": rng.normal(size=cfg.d_model).astype(np.float32),
            "bias": rng.normal(size=cfg.d_model).astype(np.float32)}
    _close(port_layers.apply_norm(
        {k: torch.as_tensor(v) for k, v in norm.items()}, torch.as_tensor(x)),
        ref.layers.apply_norm({k: ref.jnp.asarray(v) for k, v in norm.items()},
                              ref.jnp.asarray(x)))


def test_seeded_init_matches_reference_shapes_and_scales(ref):
    rcfg, cfg = ref.get_config("glm4_9b").reduced(), \
        port_configs.get_config("glm4_9b").reduced()
    rp = ref.jax.eval_shape(lambda: ref.init_model(
        ref.jax.random.PRNGKey(0), rcfg))
    p = lm.init_model(cfg, "cpu", seed=5)
    flat = ref.jax.tree_util.tree_flatten_with_path(rp)[0]
    for path, leaf in flat:
        names = [getattr(k, "key", None) for k in path]
        if names[0] == "layers":
            got = p["layers"][0]
            for n in names[1:]:
                got = got[n]
            assert (cfg.num_layers,) + tuple(got.shape) == leaf.shape, names
        else:
            got = p
            for n in names:
                got = got[n]
            assert tuple(got.shape) == leaf.shape, names
        assert str(got.dtype).split(".")[-1] == leaf.dtype.name, names
    d = cfg.d_model
    assert abs(float(p["layers"][0]["attn"]["wq"].std()) - d ** -0.5) < 0.1 * d ** -0.5
    again = lm.init_model(cfg, "cpu", seed=5)
    assert torch.equal(p["embed"], again["embed"])
    assert torch.equal(p["layers"][1]["ffn"]["w_out"],
                       again["layers"][1]["ffn"]["w_out"])


def test_init_and_grow_cache_match_reference(ref):
    for extra in ({}, {"attention": "sliding"}):
        rcfg = dataclasses.replace(ref.get_config("qwen3_4b").reduced(),
                                   **extra)
        cfg = dataclasses.replace(
            port_configs.get_config("qwen3_4b").reduced(), **extra)
        for seq in (40, 100):
            rc = ref.init_cache(rcfg, 3, seq)
            c = lm.init_cache(cfg, 3, seq, "cpu")
            for name in ("k", "v"):
                assert tuple(c["layers"][name].shape) == \
                    rc["layers"][name].shape
            assert c["first_dense"] == rc["first_dense"] == []
    rng = np.random.default_rng(0)
    k = rng.normal(size=(2, 3, 5, 4, 8)).astype(np.float32)
    rc = ref.grow_cache({"layers": {"k": ref.jnp.asarray(k),
                                    "v": ref.jnp.asarray(k)}}, 9)
    c = lm.grow_cache({"layers": {"k": torch.as_tensor(k),
                                  "v": torch.as_tensor(k)}}, 9)
    _close(c["layers"]["k"], rc["layers"]["k"], dict(rtol=0, atol=0))


# ---------------------------------------------------------------------------
# the model on the reference's weights
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(ARCHS) + ["nemotron4_340b"])
def test_prefill_matches_reference(ref, name):
    arch, extra = ARCHS.get(name, (name, {}))
    model = _model(ref, arch, **extra)
    tokens = np.random.default_rng(1).integers(1, 512, (2, PROMPT))
    (rl, rc, rlen), (logits, cache, lengths) = _prefill_both(ref, model,
                                                             tokens)
    _close(logits, rl)
    for n in ("k", "v"):
        _close(cache["layers"][n], rc["layers"][n])
    assert lengths.tolist() == np.asarray(rlen).tolist()


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_decode_matches_reference(ref, name, flash):
    """8 decode steps against both of the reference's branches (its plain
    decode attention and its Pallas flash-decode kernel), rows of one
    bucket at their own lengths, and the caches after them."""
    arch, extra = ARCHS[name]
    model = _model(ref, arch, **extra)
    tokens = np.random.default_rng(2).integers(1, 512, (2, PROMPT))
    (rl, rc, _), (_, cache, _) = _prefill_both(ref, model, tokens)
    rc = ref.grow_cache(rc, GROW)
    cache = lm.grow_cache(cache, GROW)
    lengths = np.array([PROMPT - 4, PROMPT], np.int32)
    rc, cache = _decode_both(ref, model, rc, cache,
                             np.asarray(rl).argmax(-1)[:, None], lengths,
                             flash)
    for n in ("k", "v"):
        _close(cache["layers"][n], rc["layers"][n])


@pytest.mark.parametrize("flash", [False, True])
def test_sliding_ring_buffer_wraps(ref, flash):
    """A sliding-window config (window 64): a 56-token prompt, the cache
    grown to the window, then 16 steps, so slots 56-63 fill and the next
    8 tokens overwrite slots 0-7 of the ring."""
    model = _model(ref, "qwen3_4b", attention="sliding")
    assert model[1].window == 64
    tokens = np.random.default_rng(3).integers(1, 512, (2, 56))
    (rl, rc, _), (logits, cache, _) = _prefill_both(ref, model, tokens)
    _close(logits, rl)
    rc = ref.grow_cache(rc, 64)
    cache = lm.grow_cache(cache, 64)
    lengths = np.array([50, 56], np.int32)
    rc, cache = _decode_both(ref, model, rc, cache,
                             np.asarray(rl).argmax(-1)[:, None], lengths,
                             flash, steps=16)
    assert cache["layers"]["k"].shape[2] == 64
    for n in ("k", "v"):
        _close(cache["layers"][n], rc["layers"][n])


def test_bf16_decode_matches_reference(ref):
    model = _model(ref, "qwen3_4b", dtype="bfloat16")
    tokens = np.random.default_rng(4).integers(1, 512, (2, PROMPT))
    (rl, rc, _), (logits, cache, _) = _prefill_both(ref, model, tokens)
    scale = float(np.abs(np.asarray(rl)).max())
    tol = dict(rtol=2e-2, atol=2e-2 * scale)
    _close(logits, rl, tol)
    rc = ref.grow_cache(rc, GROW)
    cache = lm.grow_cache(cache, GROW)
    _decode_both(ref, model, rc, cache, np.asarray(rl).argmax(-1)[:, None],
                 np.array([PROMPT - 4, PROMPT], np.int32), True, tol)


def test_in_place_cache_write_matches_reference_cache(ref):
    """The port writes the new K/V row in place; the reference returns a new
    cache. Starting from the same noisy cache, the two agree everywhere."""
    model = _model(ref, "qwen3_4b")
    rcfg, cfg, rp, p, _, decode = model
    rng = np.random.default_rng(5)
    shape = ref.init_cache(rcfg, 2, 48)["layers"]["k"].shape
    noise = {n: rng.normal(0, 0.1, shape).astype(np.float32)
             for n in ("k", "v")}
    rc = {"first_dense": [], "layers": {n: ref.jnp.asarray(x)
                                        for n, x in noise.items()}}
    cache = cache_from_reference(rc, "cpu")
    tokens = np.array([[3], [7]])
    lengths = np.array([5, 47], np.int32)
    rl, rc = decode[True](rp, ref.jnp.asarray(tokens, ref.jnp.int32), rc,
                          ref.jnp.asarray(lengths))
    before = cache["layers"]["k"].clone()
    logits, out = lm.serve_step(p, cfg, torch.as_tensor(tokens), cache,
                                torch.as_tensor(lengths))
    assert out is cache
    _close(logits, rl)
    for n in ("k", "v"):
        _close(cache["layers"][n], rc["layers"][n])
    changed = (cache["layers"]["k"] != before).any(dim=(0, 3, 4))
    assert changed.nonzero().tolist() == [[0, 5], [1, 47]]


# ---------------------------------------------------------------------------
# the serve loop
# ---------------------------------------------------------------------------
def test_serve_loop_matches_reference(ref):
    """Same seed: the same prompts, lengths and buckets; on the reference's
    weights, the same greedy tokens for request 0."""
    args = argparse.Namespace(arch="qwen3_4b", reduced=True, requests=5,
                              min_prompt=6, max_prompt=40, max_new=6, seed=0,
                              device="cpu")
    expect = ref.serve.serve(args)
    rcfg = ref.get_config("qwen3_4b").reduced()
    tree = ref.jax.tree.map(np.array, ref.init_model(
        ref.jax.random.PRNGKey(args.seed), rcfg))
    params = params_from_reference(
        tree, port_configs.get_config("qwen3_4b").reduced(), "cpu")
    got = port_serve.serve(args, params=params)
    assert set(expect) <= set(got)
    for key in ("arch", "requests", "prompt_lengths", "prefill_buckets",
                "new_tokens", "finite", "sample_generation"):
        assert got[key] == expect[key], key
    assert len(got["prefill_buckets"]) > 1
    # one decode graph per bucket, as the reference compiles one decode
    # program per bucket; prefill is not captured
    assert got["decode_compiles"] == expect["decode_compiles"] \
        == len(got["prefill_buckets"])
    assert got["prefill_compiles"] == 0
    assert got["device"] == "cpu"
    assert port_serve.prefill_bucket(9) == ref.serve.prefill_bucket(9) == 16


def test_serve_cli_runs_on_cpu(capsys):
    port_serve.main(["--device", "cpu", "--reduced", "--requests", "2",
                     "--max-new", "3"])
    out = capsys.readouterr().out
    assert '"finite": true' in out and '"prefill_compiles": 0' in out
    report = json.loads(out)
    assert report["decode_compiles"] == len(report["prefill_buckets"])
