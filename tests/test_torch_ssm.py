"""The port's SSM and recurrent blocks (``repro_torch.models.ssm``) and the
block-pattern LMs against the reference on the same weights: xlstm-125m
reduced (mLSTM + sLSTM, d 256, 4 heads) and a zamba2 hybrid, the reduced
config with ``block_pattern=("mamba", "shared_attn")`` and 4 layers, so
that the one shared attention+FFN block is applied twice.

The reference (``repro.models.ssm``, ``repro.models.lm``) runs on CPU
JAX; its weights, taken to numpy, reach the port through
``repro_torch.models.convert.params_from_reference``. Inputs come from
numpy seeds. Both configs take ``chunk_size`` 8 and sequence lengths that
are not multiples of it, so the chunk carry and the padding run.

Tolerances (the packages differ by summation order):

* the chunked core, the step and each block's forward, state and decode,
  f32, at 1e-5 (abs + rel), states of an sLSTM (its ``m`` starts at
  -1e30) at 1e-5 relative to their largest entry;
* ``train_loss`` at 1e-5 relative, each gradient leaf (the shared
  block's, summed over its applications, too) at 2e-5 of its largest
  reference entry, as the dense LM's tests hold them;
* prefill and decode logits and every cache leaf at 1e-4 (abs + rel), as
  the dense LM's; prefill then decode against the train forward at 1e-4;
* the hybrid in bf16: decode logits at 5e-2 of the largest logit (a few
  bf16 roundings in another order over 4 layers) and argmax-equal.
"""
import argparse
import contextlib
import dataclasses
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config                      # noqa: E402
from repro_torch.launch import serve as port_serve              # noqa: E402
from repro_torch.launch import train as port_train              # noqa: E402
from repro_torch.models import lm, ssm                          # noqa: E402
from repro_torch.models.convert import (cache_from_reference,   # noqa: E402
                                        params_from_reference,
                                        params_to_reference,
                                        tensor_from_numpy)
from repro_torch.models.inputs import make_batch                # noqa: E402
from repro_torch.tree import tree_leaves, value_and_grad        # noqa: E402

CPU = torch.device("cpu")
CHUNK = 8
TOL = dict(rtol=1e-5, atol=1e-5)
F32 = dict(rtol=1e-4, atol=1e-4)
# arch label: (config name, the fields that shape the reduced config)
ARCHS = {"xlstm": ("xlstm_125m", {}),
         "hybrid": ("zamba2_1p2b", {"block_pattern": ("mamba",
                                                      "shared_attn"),
                                    "num_layers": 4})}


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as ref_config
    from repro.models import lm as ref_lm
    from repro.models import ssm as ref_ssm
    from repro.models.inputs import make_batch as ref_batch
    return argparse.Namespace(jax=jax, jnp=jnp, get_config=ref_config,
                              lm=ref_lm, ssm=ref_ssm, make_batch=ref_batch,
                              memo={})


def _configs(ref, arch, **extra):
    name, fields = ARCHS[arch]
    fields = {**fields, "chunk_size": CHUNK, **extra}
    return (dataclasses.replace(ref.get_config(name).reduced(), **fields),
            dataclasses.replace(get_config(name).reduced(), **fields))


def _model(ref, arch, **extra):
    """(reference cfg, port cfg, reference params, their numpy tree, port
    params), memoized per arch and config."""
    key = (arch, tuple(sorted(extra.items())))
    if key not in ref.memo:
        rcfg, cfg = _configs(ref, arch, **extra)
        if extra.get("dtype") == "bfloat16":
            # the same draws cast: the f32 model's weights in the bf16
            # model's dtypes (its f32 leaves stay f32)
            like = ref.jax.eval_shape(lambda: ref.lm.init_model(
                ref.jax.random.PRNGKey(0), rcfg))
            rp = ref.jax.tree.map(lambda a, sd: a.astype(sd.dtype),
                                  _model(ref, arch)[2], like)
        else:
            rp = ref.jax.jit(lambda key: ref.lm.init_model(key, rcfg))(
                ref.jax.random.PRNGKey(0))
        tree = ref.jax.tree.map(np.array, rp)
        ref.memo[key] = (rcfg, cfg, rp, tree,
                         params_from_reference(tree, cfg, CPU))
    return ref.memo[key]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, expect, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(expect), **tol)


def _close_scaled(got, expect, rtol):
    """Within ``rtol`` of the largest reference entry."""
    g, e = _np(got), _np(expect)
    assert g.shape == e.shape
    assert np.abs(g - e).max() <= rtol * max(np.abs(e).max(), 1e-30)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return tensor_from_numpy(np.asarray(tree), CPU)


def _rng_arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


# ---------------------------------------------------------------------------
# the chunked core and the step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("normalize", [False, True])
def test_chunked_linear_attention_matches_reference(ref, normalize):
    """B 2, S 21 (chunks of 8, the last padded), H 3, Dk 5, Dv 4; the whole
    sequence, then the same split at 13 with the state (and the norm)
    handed over: both against the reference, and the handoff against the
    whole run."""
    q, k, v, ld = _rng_arrays(0, (2, 21, 3, 5), (2, 21, 3, 5), (2, 21, 3, 4),
                              (2, 21, 3))
    ld = -np.abs(ld) * 0.3
    j = ref.jnp.asarray
    t = torch.as_tensor
    core = ref.jax.jit(ref.ssm.chunked_linear_attention,
                       static_argnames=("chunk", "normalize"))
    want = core(j(q), j(k), j(v), j(ld), None, CHUNK, normalize=normalize)
    got = ssm.chunked_linear_attention(t(q), t(k), t(v), t(ld), None, CHUNK,
                                       normalize=normalize)
    for g, w in zip(got, want, strict=True):
        _close(g, w)
    a = slice(0, 13)
    b = slice(13, 21)
    w1 = core(j(q[:, a]), j(k[:, a]), j(v[:, a]), j(ld[:, a]), None, CHUNK,
              normalize=normalize)
    w2 = core(j(q[:, b]), j(k[:, b]), j(v[:, b]), j(ld[:, b]), w1[1], CHUNK,
              normalize=normalize, norm_state=w1[2])
    g1 = ssm.chunked_linear_attention(t(q[:, a]), t(k[:, a]), t(v[:, a]),
                                      t(ld[:, a]), None, CHUNK,
                                      normalize=normalize)
    g2 = ssm.chunked_linear_attention(t(q[:, b]), t(k[:, b]), t(v[:, b]),
                                      t(ld[:, b]), g1[1], CHUNK,
                                      normalize=normalize, norm_state=g1[2])
    for g, w in zip(g1 + g2, w1 + w2, strict=True):
        _close(g, w)
    _close(g2[1], got[1])
    _close(torch.cat([g1[0], g2[0]], dim=1), got[0])


def test_linear_attention_step_matches_reference_and_the_core(ref):
    """One step from a nonzero state against the reference, and 5 steps
    against the chunked core over the same 5 tokens."""
    q, k, v, ld, s0, n0 = _rng_arrays(1, (2, 5, 3, 4), (2, 5, 3, 4),
                                      (2, 5, 3, 6), (2, 5, 3), (2, 3, 4, 6),
                                      (2, 3, 4))
    ld = -np.abs(ld) * 0.3
    j, t = ref.jnp.asarray, torch.as_tensor
    want = ref.ssm.linear_attention_step(j(q[:, 0]), j(k[:, 0]), j(v[:, 0]),
                                         j(ld[:, 0]), j(s0), j(n0))
    got = ssm.linear_attention_step(t(q[:, 0]), t(k[:, 0]), t(v[:, 0]),
                                    t(ld[:, 0]), t(s0), t(n0))
    for g, w in zip(got, want, strict=True):
        _close(g, w)
    S, n = t(s0), t(n0)
    ys = []
    for i in range(5):
        y, S, n = ssm.linear_attention_step(t(q[:, i]), t(k[:, i]),
                                            t(v[:, i]), t(ld[:, i]), S, n)
        ys.append(y)
    y, S_c, n_c = ssm.chunked_linear_attention(t(q), t(k), t(v), t(ld), t(s0),
                                               CHUNK, norm_state=t(n0))
    _close(torch.stack(ys, dim=1), y)
    _close(S, S_c)
    _close(n, n_c)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------
BLOCK_CASES = {"mamba": ("hybrid", 13), "mamba_short": ("hybrid", 2),
               "mlstm": ("xlstm", 13), "slstm": ("xlstm", 13)}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_block_forward_state_and_decode_match_reference(ref, case):
    """The block's forward over ``[2, S, d]`` with its returned state
    (mamba's conv tail left-padded when S < K - 1: the ``mamba_short``
    case), then 3 decode steps from that state, output and state each
    step."""
    kind = case.split("_")[0]
    arch, s = BLOCK_CASES[case]
    rcfg, cfg = _configs(ref, arch)
    init = getattr(ref.ssm, f"init_{kind}")
    rp = ref.jax.tree.map(np.array, init(ref.jax.random.PRNGKey(2), rcfg))
    if kind == "mamba":          # nonzero A_log, D, dt_bias
        rng = np.random.default_rng(5)
        for name in ("A_log", "D", "dt_bias"):
            rp[name] = rp[name] + rng.normal(
                size=rp[name].shape).astype(np.float32) * 0.3
    p = _torch(rp)
    x, steps = _rng_arrays(3, (2, s, cfg.d_model), (3, 2, 1, cfg.d_model))
    ref_fwd = getattr(ref.ssm, f"{kind}_forward")
    ref_dec = getattr(ref.ssm, f"{kind}_decode_step")
    kw = {"return_state": True} if kind == "mamba" else {}
    fwd = ref.jax.jit(lambda p, x: ref_fwd(p, rcfg, x, **kw))
    dec = ref.jax.jit(lambda p, x, st: ref_dec(p, rcfg, x, st))
    want, wstate = fwd(rp, ref.jnp.asarray(x))
    got, state = ssm.BLOCKS[kind].forward(p, cfg, torch.as_tensor(x), **kw)
    _close(got, want)
    assert sorted(state) == sorted(wstate)
    for name in state:
        _close_scaled(state[name], wstate[name], 1e-5)
    if kind == "mamba":
        assert state["conv"].shape == (2, cfg.conv_kernel - 1,
                                       2 * cfg.d_model
                                       + 2 * cfg.ssm_state_dim)
    for xt in steps:
        want, wstate = dec(rp, ref.jnp.asarray(xt), wstate)
        got, state = ssm.BLOCKS[kind].decode(p, cfg, torch.as_tensor(xt),
                                             state)
        _close(got, want)
        for name in state:
            _close_scaled(state[name], wstate[name], 1e-5)


# ---------------------------------------------------------------------------
# the model on the reference's weights
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_loss_and_grads_match_reference(ref, arch):
    """``train_loss`` and every gradient leaf, batch 2 x 13; the hybrid's
    shared block's gradient is the sum over its two applications (unlike
    either application's alone)."""
    rcfg, cfg, rp, _, params = _model(ref, arch)
    rbatch = ref.make_batch(rcfg, 2, 13, seed=0)
    batch = make_batch(cfg, 2, 13, seed=0)
    want_loss, want_grads = ref.jax.jit(ref.jax.value_and_grad(
        lambda p, b: ref.lm.train_loss(p, rcfg, b)))(rp, rbatch)
    loss, grads = value_and_grad(lambda p: lm.train_loss(p, cfg, batch),
                                 params)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    got_tree = params_to_reference(grads, cfg)
    assert ref.jax.tree_util.tree_structure(got_tree) == \
        ref.jax.tree_util.tree_structure(want_grads)
    for g, w in zip(ref.jax.tree.leaves(got_tree),
                    ref.jax.tree.leaves(want_grads), strict=True):
        _close_scaled(g, w, 2e-5)
    if arch == "hybrid":
        shared = grads["shared_attn"]["attn"]["wq"]
        assert float(shared.abs().max()) > 0
        assert grads["layers"][1] == {} and grads["layers"][3] == {}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_and_decode_match_reference(ref, arch):
    """Prefill over a 19-token bucket, its cache against the reference's
    (per layer: K/V, or the block's state), then 4 decode steps, rows at
    their own lengths (15 and 19), the reference's greedy token fed to
    both: logits and every cache leaf each step. The port's cache is the
    same object after each step (written in place)."""
    rcfg, cfg, rp, _, params = _model(ref, arch)
    tokens = np.random.default_rng(3).integers(1, 512, (2, 19))
    rl, rc, _ = ref.jax.jit(lambda p, b: ref.lm.prefill_step(p, rcfg, b))(
        rp, {"tokens": ref.jnp.asarray(tokens, ref.jnp.int32)})
    logits, cache, lengths = lm.prefill_step(
        params, cfg, {"tokens": torch.as_tensor(tokens, dtype=torch.int32)})
    _close(logits, rl, F32)
    assert lengths.tolist() == [19, 19]

    def leaves_close(cache, rc):
        assert ref.jax.tree_util.tree_structure(
            ref.jax.tree.map(lambda t: 0, cache)) == \
            ref.jax.tree_util.tree_structure(ref.jax.tree.map(lambda t: 0,
                                                              rc))
        for g, w in zip(ref.jax.tree.leaves(cache), ref.jax.tree.leaves(rc),
                        strict=True):
            _close_scaled(g, w, 1e-4)
    leaves_close(cache, rc)
    rc = ref.lm.grow_cache(rc, 28)
    cache = lm.grow_cache(cache, 28)
    leaves_close(cache, rc)
    decode = ref.jax.jit(lambda p, t, c, n: ref.lm.serve_step(p, rcfg, t, c,
                                                              n))
    nxt = np.asarray(rl).argmax(-1)[:, None]
    lens = np.array([15, 19], np.int32)
    for _ in range(4):
        rl, rc = decode(rp, ref.jnp.asarray(nxt, ref.jnp.int32), rc,
                        ref.jnp.asarray(lens))
        logits, out = lm.serve_step(params, cfg,
                                    torch.as_tensor(nxt, dtype=torch.int32),
                                    cache, torch.as_tensor(lens))
        assert out is cache
        _close(logits, rl, F32)
        leaves_close(cache, rc)
        nxt, lens = np.asarray(rl).argmax(-1)[:, None], lens + 1
    # the reference's cache, carried over, decodes as the port's own
    mine, _ = lm.serve_step(params, cfg,
                            torch.as_tensor(nxt, dtype=torch.int32),
                            cache_from_reference(
                                ref.jax.tree.map(np.array, rc), CPU),
                            torch.as_tensor(lens))
    want, _ = decode(rp, ref.jnp.asarray(nxt, ref.jnp.int32), rc,
                     ref.jnp.asarray(lens))
    _close(mine, want, F32)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_then_decode_matches_the_train_forward(ref, arch):
    """Prefill of S - 1 tokens then one decode step gives the train
    forward's logits at position S - 1 (S 17: two chunks and a third
    padded)."""
    _, cfg, _, _, params = _model(ref, arch)
    s = 17
    tokens = make_batch(cfg, 2, s, seed=4)["tokens"]
    with torch.no_grad():
        h, _ = lm.model_hidden_train(params, cfg, tokens)
        want = (h[:, -1] @ lm._head_weight(params)).float()
        _, cache, lens = lm.prefill_step(params, cfg,
                                         {"tokens": tokens[:, :s - 1]})
        cache = lm.grow_cache(cache, s + 4)
        got, _ = lm.serve_step(params, cfg, tokens[:, s - 1:], cache, lens)
    _close(got, want, F32)


def test_bf16_decode_matches_reference(ref):
    """The hybrid in bf16 (the f32 leaves stay f32): prefill of 11 tokens
    and 3 decode steps, logits within 5e-2 of the largest and the same
    greedy tokens; the SSM states stay f32 and the conv window bf16."""
    rcfg, cfg, rp, _, params = _model(ref, "hybrid", dtype="bfloat16")
    assert params["layers"][0]["mamba"]["A_log"].dtype == torch.float32
    assert params["layers"][0]["mamba"]["w_in"].dtype == torch.bfloat16
    tokens = np.random.default_rng(6).integers(1, 512, (2, 11))
    rl, rc, _ = ref.jax.jit(lambda p, b: ref.lm.prefill_step(p, rcfg, b))(
        rp, {"tokens": ref.jnp.asarray(tokens, ref.jnp.int32)})
    logits, cache, _ = lm.prefill_step(
        params, cfg, {"tokens": torch.as_tensor(tokens, dtype=torch.int32)})
    rc, cache = ref.lm.grow_cache(rc, 16), lm.grow_cache(cache, 16)
    assert cache["layers"][0]["ssm"].dtype == torch.float32
    assert cache["layers"][0]["conv"].dtype == torch.bfloat16
    decode = ref.jax.jit(lambda p, t, c, n: ref.lm.serve_step(p, rcfg, t, c,
                                                              n))
    lens = np.array([9, 11], np.int32)
    for _ in range(3):
        _close_scaled(logits, rl, 5e-2)
        assert (_np(logits).argmax(-1) == np.asarray(rl).argmax(-1)).all()
        nxt = np.asarray(rl).argmax(-1)[:, None]
        rl, rc = decode(rp, ref.jnp.asarray(nxt, ref.jnp.int32), rc,
                        ref.jnp.asarray(lens))
        logits, _ = lm.serve_step(params, cfg,
                                  torch.as_tensor(nxt, dtype=torch.int32),
                                  cache, torch.as_tensor(lens))
        lens = lens + 1
    _close_scaled(logits, rl, 5e-2)


@pytest.mark.parametrize("arch,dtype", [("xlstm", "float32"),
                                        ("hybrid", "float32"),
                                        ("hybrid", "bfloat16")])
def test_params_round_trip(ref, arch, dtype):
    """``params_to_reference(params_from_reference(t)) == t`` bit for bit,
    the ``{}`` at each shared position and ``shared_attn`` included; the
    port's per-layer list has the reference's kinds."""
    _, cfg, _, tree, params = _model(
        ref, arch, **({} if dtype == "float32" else {"dtype": dtype}))
    assert isinstance(params["layers"], list)
    for lp, kind in zip(params["layers"], cfg.blocks, strict=True):
        assert (lp == {}) if kind == "shared_attn" else (kind in lp
                                                         or "attn" in lp)
    assert ("shared_attn" in params) == (arch == "hybrid")
    back = params_to_reference(params, cfg)
    flat_t, def_t = ref.jax.tree_util.tree_flatten(tree)
    flat_b, def_b = ref.jax.tree_util.tree_flatten(back)
    assert def_t == def_b
    for a, b in zip(flat_t, flat_b, strict=True):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_seeded_init_and_cache_match_reference_structure(ref, arch):
    """The port's seeded weights and zero cache have the reference's tree,
    shapes and dtypes (the sLSTM's ``m`` starts at -1e30)."""
    jax = ref.jax
    rcfg, cfg = _configs(ref, arch, dtype="bfloat16")
    shapes = jax.eval_shape(lambda: ref.lm.init_model(jax.random.PRNGKey(0),
                                                      rcfg))
    zero = ref.jax.tree.map(np.array, ref.lm.init_cache(rcfg, 2, 16))
    params = lm.init_model(cfg, CPU, seed=1)
    cache = lm.init_cache(cfg, 2, 16, CPU)
    for mine, theirs in ((params, shapes), (cache, zero)):
        assert jax.tree_util.tree_structure(
            jax.tree.map(lambda t: 0, mine)) == \
            jax.tree_util.tree_structure(jax.tree.map(lambda t: 0, theirs))
        for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs),
                        strict=True):
            assert tuple(a.shape) == b.shape
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
    for a, b in zip(jax.tree.leaves(cache), jax.tree.leaves(zero),
                    strict=True):
        np.testing.assert_array_equal(_np(a), np.asarray(b, np.float32))


# ---------------------------------------------------------------------------
# the captured decode's warm-up
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _emulated_card(monkeypatch):
    """The card's capture on the CPU: warm-up and capture run eagerly, a
    replay runs nothing."""
    cuda = torch.cuda
    ns = types.SimpleNamespace
    monkeypatch.setattr(cuda, "CUDAGraph", lambda: ns(replay=lambda: None))
    monkeypatch.setattr(cuda, "graph",
                        lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(cuda, "Stream", lambda device: ns(
        wait_stream=lambda other: None))
    monkeypatch.setattr(cuda, "current_stream", lambda device=None: ns(
        wait_stream=lambda other: None))
    monkeypatch.setattr(cuda, "stream", lambda s: contextlib.nullcontext())
    yield


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_captured_decode_advances_each_state_once(ref, arch, monkeypatch):
    """A captured decode's first call runs the warm-up, then the capture:
    the cache (bound by address) must end as one eager step leaves it,
    every recurrent state advanced once, not twice."""
    _, cfg, _, _, params = _model(ref, arch)
    tokens = make_batch(cfg, 2, 12, seed=5)["tokens"]
    with torch.no_grad():
        logits, cache, lens = lm.prefill_step(params, cfg,
                                              {"tokens": tokens})
    nxt = logits.argmax(-1).to(torch.int32)[:, None]
    grown = [lm.grow_cache(cache, 16) for _ in range(2)]
    eager = port_serve.make_decode(params, cfg, CPU, capture=False)
    with torch.no_grad():
        eager(nxt, lens.clone(), grown[0])
        with _emulated_card(monkeypatch):
            step = port_serve.make_decode(params, cfg, CPU)
            step.cuda = True
            step(nxt, lens.clone(), grown[1])
    assert step.compiles == 1
    for a, b in zip(tree_leaves(grown[0]), tree_leaves(grown[1]),
                    strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_serve_captures_one_graph_per_bucket(arch, monkeypatch):
    """``launch.serve`` on the emulated card, 4 requests in two buckets of
    2 rows each: an xLSTM's cache has no sequence axis, so both buckets
    give the decode one signature with two caches; each bucket's own step
    captures its own graph at its own cache (one step for all buckets
    would be handed a borrowed cache at another address)."""
    made = []

    def on_card(*a, **k):
        step = make_decode(*a, **k)
        step.cuda = True
        made.append(step)
        return step
    make_decode = port_serve.make_decode
    monkeypatch.setattr(port_serve, "make_decode", on_card)
    args = port_serve.parser().parse_args(
        ["--device", "cpu", "--arch", ARCHS[arch][0], "--reduced",
         "--requests", "4", "--max-prompt", "24", "--max-new", "3"])
    with torch.no_grad(), _emulated_card(monkeypatch):
        report = port_serve.serve(args)
    assert report["prefill_buckets"] == {"16": 2, "32": 2}
    assert report["decode_compiles"] == 2
    assert [s.compiles for s in made] == [1, 1]


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_serve_cli_runs_on_cpu(arch, capsys):
    """``launch.serve --arch <xlstm_125m | zamba2_1p2b> --reduced --device
    cpu``: finite logits, one decode graph a bucket, and the captured
    decode (the CPU runs its plumbing) gives the eager decode's tokens."""
    name = ARCHS[arch][0]
    port_serve.main(["--device", "cpu", "--arch", name, "--reduced",
                     "--requests", "3", "--max-new", "4"])
    report = json.loads(capsys.readouterr().out)
    assert report["finite"] and report["arch"] == get_config(name).name
    assert report["decode_compiles"] == len(report["prefill_buckets"]) > 1
    args = port_serve.parser().parse_args(
        ["--device", "cpu", "--arch", name, "--reduced", "--requests", "2",
         "--max-prompt", "16", "--max-new", "3"])
    runs = [port_serve.serve(args, capture=c) for c in (True, False)]
    assert runs[0]["sample_generation"] == runs[1]["sample_generation"]
    assert runs[1]["decode_compiles"] == 0


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_cli_trains_and_checkpoints(ref, arch, tmp_path):
    """``launch.train --workload lm --arch <...> --reduced``: 2 steps at
    seq 12, the loss falls, one graph, and the checkpoint (the hybrid's
    ``{}`` entries and ``shared_attn`` included) restores in the
    reference bit for bit as the trained parameters."""
    from repro.checkpoint import restore_checkpoint
    name = ARCHS[arch][0]
    args = port_train.parser().parse_args(
        ["--device", "cpu", "--workload", "lm", "--arch", name, "--reduced",
         "--steps", "2", "--seq", "12", "--ckpt-dir", str(tmp_path)])
    rep, state = port_train.run_lm(args)
    assert rep["steps"] == len(rep["losses"]) == 2
    assert all(np.isfinite(rep["losses"]))
    assert rep["last_loss"] < rep["first_loss"]
    assert state["step"].compiles == 1
    cfg, params = state["cfg"], state["params"]
    like = ref.jax.eval_shape(lambda: ref.lm.init_model(
        ref.jax.random.PRNGKey(0), ref.get_config(name).reduced()))
    restored = restore_checkpoint(str(tmp_path), like)
    mine = params_to_reference(params, cfg)
    assert ref.jax.tree_util.tree_structure(restored) == \
        ref.jax.tree_util.tree_structure(mine)
    for got, want in zip(ref.jax.tree.leaves(restored),
                         ref.jax.tree.leaves(mine), strict=True):
        np.testing.assert_array_equal(np.asarray(got), want)
