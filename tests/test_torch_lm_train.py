"""The port's LM training (train forward, chunked CE, in-place AdamW,
schedules, the train step) and ``launch.train`` against the reference.

The reference (``repro.models.lm``, ``repro.launch.steps``,
``repro.optim``, ``repro.launch.train``) runs on CPU JAX, its steps under
``jax.jit``. Its ``init_model`` weights, taken to numpy, reach the port
through ``repro_torch.models.convert.params_from_reference``; batches come
from the same numpy seed in both packages.

Tolerances (f32 from end to end; the packages differ by summation order):

* ``train_loss`` at 1e-5 relative, each gradient leaf at 2e-5 of its
  largest reference entry (measured 2.0e-6);
* three AdamW steps at lr 5e-3: losses at 1e-4 relative (measured 7.8e-6
  at step 3), ``mu`` and ``nu`` at 1e-3 of each leaf's largest entry
  (measured 1.8e-4), parameters at 0.2 lr everywhere (measured 0.13 lr)
  and at 1e-5 on all but 0.1% of the entries (measured 0.033%). Adam
  divides each moment by the root of the second: an entry whose gradient
  is near 0 moves by up to lr either way on a rounding of that gradient,
  which is why a few entries differ by a good part of lr after one step
  already (195 of 2.3 M by more than 1e-5);
* ``adamw_update_`` on identical inputs: bitwise equal to the port's
  ``adamw_update`` on f32 leaves; on bf16 leaves against the reference's,
  the moments at 1e-5 relative (the global norm sums in another order:
  measured 1.3e-6; a clip applied to the bf16 gradient would be off by
  ~2e-3) and the parameters at one bf16 rounding;
* the schedules at 1e-6 relative.
"""
import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import graphs                                  # noqa: E402
from repro_torch.configs import get_config                      # noqa: E402
from repro_torch.launch import steps as port_steps              # noqa: E402
from repro_torch.launch import train as port_train              # noqa: E402
from repro_torch.models import lm                               # noqa: E402
from repro_torch.models.convert import (params_from_reference,  # noqa: E402
                                        params_to_reference)
from repro_torch.models.inputs import make_batch                # noqa: E402
from repro_torch.optim import (adamw_init, adamw_update,        # noqa: E402
                               adamw_update_, constant_schedule,
                               cosine_schedule, linear_warmup_cosine)
from repro_torch.tree import (tree_leaves, tree_map,            # noqa: E402
                              value_and_grad)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 5e-3
B, S = 2, 40
ARCHS = ["qwen3_4b", "glm4_9b"]     # qk-norm, 4/4 heads; qkv-bias, GQA 4/2


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as ref_config
    from repro.launch.steps import make_train_step
    from repro.models import inputs, lm as ref_lm
    from repro.optim import adamw, schedules
    return argparse.Namespace(jax=jax, jnp=jnp, get_config=ref_config,
                              make_train_step=make_train_step,
                              inputs=inputs, lm=ref_lm, adamw=adamw,
                              schedules=schedules, memo={})


def _leaves(tree):
    """A reference (numpy or JAX) tree's leaves as numpy arrays."""
    import jax
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _model(ref, arch):
    """(reference cfg, port cfg, reference params, their numpy tree, the
    reference's batch, the port's batch), memoized per arch."""
    if arch not in ref.memo:
        rcfg = ref.get_config(arch).reduced()
        cfg = get_config(arch).reduced()
        rp = ref.lm.init_model(ref.jax.random.PRNGKey(0), rcfg)
        tree = ref.jax.tree.map(np.array, rp)
        ref.memo[arch] = (rcfg, cfg, rp, tree,
                          ref.inputs.make_batch(rcfg, B, S, seed=0),
                          make_batch(cfg, B, S, seed=0))
    return ref.memo[arch]


# ---------------------------------------------------------------------------
# train_loss, its gradients, three train steps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference(ref, arch):
    rcfg, cfg, rp, tree, rbatch, batch = _model(ref, arch)
    np.testing.assert_array_equal(batch["tokens"].numpy(),
                                  np.asarray(rbatch["tokens"]))
    want_loss, want_grads = ref.jax.jit(ref.jax.value_and_grad(
        lambda p, b: ref.lm.train_loss(p, rcfg, b)))(rp, rbatch)
    for remat in (False, True):         # remat changes no number
        c = dataclasses.replace(cfg, remat=remat)
        params = params_from_reference(tree, c, "cpu")
        loss, grads = value_and_grad(
            lambda p: lm.train_loss(p, c, batch), params)
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
        got = _leaves(params_to_reference(grads, c))
        for g, w in zip(got, _leaves(want_grads), strict=True):
            assert np.abs(g - w).max() <= 2e-5 * np.abs(w).max()


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_reference(ref, arch):
    rcfg, cfg, rp, tree, rbatch, batch = _model(ref, arch)
    step = ref.jax.jit(ref.make_train_step(rcfg, lr=LR))
    ropt, rparams, want_losses = ref.adamw.adamw_init(rp), rp, []
    for _ in range(3):
        rparams, ropt, loss = step(rparams, ropt, rbatch)
        want_losses.append(float(loss))
    params = params_from_reference(tree, cfg, "cpu")   # views: fine
    opt = adamw_init(params)
    train = port_steps.make_train_step(cfg, lr=LR, device="cpu")
    losses = []
    for _ in range(3):
        p2, o2, loss = train(params, opt, batch)
        assert all(a is b for a, b in zip(        # written in place
            tree_leaves((p2, o2)), tree_leaves((params, opt)), strict=True))
        losses.append(float(loss))
    assert train.compiles == 1 and int(opt.step) == int(ropt.step) == 3
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    assert losses[-1] < losses[0]
    for got, want in ((opt.mu, ropt.mu), (opt.nu, ropt.nu)):
        for g, w in zip(_leaves(params_to_reference(got, cfg)), _leaves(want),
                        strict=True):
            assert np.abs(g - w).max() <= 1e-3 * np.abs(w).max()
    diff = np.concatenate([
        np.abs(g - w).ravel() for g, w in zip(
            _leaves(params_to_reference(params, cfg)), _leaves(rparams),
            strict=True)])
    assert diff.max() <= 0.2 * LR
    assert (diff > 1e-5).mean() <= 1e-3


def test_eager_step_equals_the_plumbed_step():
    """``capture=False`` and the step's plumbing (which on the CPU runs it
    eagerly on the same tensors) are the same arithmetic, bitwise."""
    cfg = get_config("qwen3_4b").reduced()
    batch = make_batch(cfg, B, S, seed=1)
    runs = []
    for capture in (True, False):
        params = lm.init_model(cfg, "cpu", seed=3)
        opt = adamw_init(params)
        train = port_steps.make_train_step(cfg, lr=cosine_schedule(LR, 3),
                                           device="cpu", capture=capture)
        losses = [train(params, opt, batch)[2].clone() for _ in range(3)]
        runs.append((losses, params, opt))
    (l1, p1, o1), (l2, p2, o2) = runs
    assert all(torch.equal(a, b) for a, b in zip(l1, l2))
    for a, b in zip(tree_leaves((p1, o1.mu, o1.nu, o1.step)),
                    tree_leaves((p2, o2.mu, o2.nu, o2.step))):
        assert torch.equal(a, b)


def test_prefill_and_decode_steps_are_the_model_functions():
    cfg = get_config("glm4_9b").reduced()
    params = lm.init_model(cfg, "cpu", seed=1)
    tokens = make_batch(cfg, 2, 12, seed=1)["tokens"]
    logits, cache, lengths = port_steps.make_prefill_step(cfg)(
        params, {"tokens": tokens})
    want = lm.prefill_step(params, cfg, {"tokens": tokens})
    assert torch.equal(logits, want[0]) and torch.equal(lengths, want[2])
    cache = lm.grow_cache(cache, 16)
    twin = lm.grow_cache(want[1], 16)
    nxt = logits.argmax(-1).to(torch.int32)[:, None]
    got, _ = port_steps.make_decode_step(cfg)(params, nxt, cache, lengths)
    assert torch.equal(got, lm.serve_step(params, cfg, nxt, twin,
                                          lengths)[0])


class _FakeGraph:
    def register_generator_state(self, gen):
        pass

    def replay(self):
        pass


def test_first_captured_call_steps_once(monkeypatch):
    """On the card (its capture emulated: the captured run executes, the
    replay does nothing) the warm-up before a capture runs the step's
    ``warmup`` and not the step, so the first call updates once."""
    cuda = torch.cuda
    monkeypatch.setattr(cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(cuda, "graph",
                        lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(cuda, "Stream", lambda device: types.SimpleNamespace(
        wait_stream=lambda other: None))
    monkeypatch.setattr(cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            wait_stream=lambda other: None))
    monkeypatch.setattr(cuda, "stream", lambda s: contextlib.nullcontext())
    calls = []

    def fn(state, x):
        calls.append("step")
        state.add_(x)
        return state

    step = graphs.CapturedStep(fn, "cpu", borrow=(0,),
                               warmup=lambda state, x: calls.append("warm"))
    step.cuda = True
    state = torch.zeros(3)
    step(state, torch.ones(3))
    assert calls == ["warm", "step"] and state.tolist() == [1.0, 1.0, 1.0]
    step(state, torch.ones(3))       # a replay (emulated: nothing runs)
    assert calls == ["warm", "step"] and step.compiles == 1


# ---------------------------------------------------------------------------
# chunked CE, remat policies
# ---------------------------------------------------------------------------
def test_chunked_ce_loss_partial_chunk_and_mask(ref):
    """S = 20 in chunks of 8 (the last padded by 4), a partial mask: the
    loss and its gradients in h and the head against the reference's; no
    tensor saved for the backward holds a chunk's logits."""
    rng = np.random.default_rng(0)
    b, s, d, v, chunk = 2, 20, 8, 50, 8
    h = rng.normal(size=(b, s, d)).astype(np.float32)
    w = (rng.normal(size=(d, v)) * 0.3).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) > 0.3).astype(np.float32)
    jnp = ref.jnp
    want, (wh, ww) = ref.jax.value_and_grad(
        lambda hh, ww_: ref.lm.chunked_ce_loss(
            hh, ww_, jnp.asarray(labels), jnp.asarray(mask), chunk=chunk),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    ht = torch.tensor(h, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.numel()) or t, lambda t: t):
        loss = lm.chunked_ce_loss(ht, wt, torch.as_tensor(labels),
                                  torch.as_tensor(mask), chunk=chunk)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(wh), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(ww), rtol=1e-5,
                               atol=1e-6)
    assert saved and max(saved) < b * chunk * v


def _count_mm_in_backward(cfg, params, batch):
    """(loss, grads, aten.mm calls during the backward)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += func is torch.ops.aten.mm.default
            return func(*args, **(kwargs or {}))

    live = tree_map(lambda x: x.detach().requires_grad_(), params)
    loss = lm.train_loss(live, cfg, batch)
    with Count():
        grads = torch.autograd.grad(loss, tree_leaves(live))
    return loss, grads, Count.n


def test_dots_remat_policy_equals_no_remat():
    """The "dots" policy (no config sets it) gives no-remat's loss and
    gradients, and recomputes no matmul in the backward ("full" redoes
    each layer's)."""
    base = get_config("qwen3_4b").reduced()
    params = lm.init_model(base, "cpu", seed=2)
    batch = make_batch(base, B, S, seed=2)
    runs = {policy: _count_mm_in_backward(
        dataclasses.replace(base, remat=policy is not None,
                            remat_policy=policy or "full"), params, batch)
        for policy in (None, "dots", "full")}
    loss0, grads0, mm0 = runs[None]
    for policy in ("dots", "full"):
        loss, grads, _ = runs[policy]
        assert torch.equal(loss, loss0)
        for g, g0 in zip(grads, grads0, strict=True):
            torch.testing.assert_close(g, g0, rtol=1e-6, atol=1e-7)
    assert runs["dots"][2] == mm0 < runs["full"][2]


# ---------------------------------------------------------------------------
# schedules, AdamW, the parameter tree
# ---------------------------------------------------------------------------
def test_schedules_match_reference(ref):
    pairs = [(constant_schedule(3e-4), ref.schedules.constant_schedule(3e-4)),
             (cosine_schedule(1e-3, 100),
              ref.schedules.cosine_schedule(1e-3, 100)),
             (cosine_schedule(1e-3, 100, final_frac=0.3),
              ref.schedules.cosine_schedule(1e-3, 100, final_frac=0.3)),
             (linear_warmup_cosine(2e-3, 10, 100),
              ref.schedules.linear_warmup_cosine(2e-3, 10, 100))]
    for step in (0, 5, 10, 55, 100, 130):     # start, warm-up, middle, end
        for mine, theirs in pairs:
            got = mine(torch.tensor(step, dtype=torch.int32))
            want = theirs(ref.jnp.asarray(step, ref.jnp.int32))
            assert got.dtype == torch.float32 and got.dim() == 0
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _trees(seed, shapes, dtype=torch.float32, k=None):
    gen = torch.Generator().manual_seed(seed)

    def leaf(shape):
        shape = ((k,) if k else ()) + shape
        return torch.randn(shape, generator=gen).to(dtype)
    params = {"a": leaf(shapes[0]), "b": [leaf(s) for s in shapes[1:]]}
    grads = tree_map(lambda p: leaf(tuple(p.shape[1:] if k else p.shape))
                     * 0.3, params)
    return params, grads


@pytest.mark.parametrize("case", ["clip_decay", "no_clip", "stacked",
                                  "schedule"])
def test_in_place_adamw_bitwise_equals_adamw_update(case):
    shapes = [(7, 5), (5,), (3, 4, 2)]
    params, grads = _trees(0, shapes, k=3 if case == "stacked" else None)
    kw = dict(weight_decay=0.01)
    if case == "no_clip":
        kw["clip_norm"] = None
    state = adamw_init(params, stacked=case == "stacked")
    mine = tree_map(torch.clone, params)
    my_state = adamw_init(mine, stacked=case == "stacked")
    sched = linear_warmup_cosine(1e-2, 2, 6)
    for i in range(4):
        grads = tree_map(lambda g: g * (1.0 + 0.1 * i), grads)
        lr = sched(state.step) if case == "schedule" else 1e-2
        params, state = adamw_update(grads, state, params, lr, **kw)
        out = adamw_update_(grads, my_state, mine, lr, **kw)
        assert out is my_state
    for a, b in zip(tree_leaves((params, state.mu, state.nu, state.step)),
                    tree_leaves((mine, my_state.mu, my_state.nu,
                                 my_state.step))):
        assert torch.equal(a, b)


def test_in_place_adamw_matches_reference_on_bf16(ref):
    """bf16 parameters and gradients: the reference clips the f32 value of
    each gradient (its promotion), as ``adamw_update_`` does."""
    jnp = ref.jnp
    params, grads = _trees(1, [(64, 32), (32,)], dtype=torch.bfloat16)
    grads = tree_map(lambda g: g * 20, grads)            # the clip bites
    to_j = (lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16))
    rparams = tree_map(to_j, params)
    rgrads = tree_map(to_j, grads)
    rstate = ref.adamw.adamw_init(rparams)
    state = adamw_init(params)
    for _ in range(3):
        rparams, rstate = ref.adamw.adamw_update(
            rgrads, rstate, rparams, 1e-2, weight_decay=0.01)
        adamw_update_(grads, state, params, 1e-2, weight_decay=0.01)
    for got, want, rtol in ((params, rparams, 2 ** -8),
                            (state.mu, rstate.mu, 1e-5),
                            (state.nu, rstate.nu, 1e-5)):
        for g, w in zip(tree_leaves(got), _leaves(want), strict=True):
            np.testing.assert_allclose(g.float().numpy(),
                                       np.asarray(w, np.float32), rtol=rtol,
                                       atol=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_to_the_reference_layout(ref, dtype):
    rcfg = dataclasses.replace(ref.get_config("glm4_9b").reduced(),
                               dtype=dtype)
    cfg = dataclasses.replace(get_config("glm4_9b").reduced(), dtype=dtype)
    tree = ref.jax.tree.map(np.array, ref.lm.init_model(
        ref.jax.random.PRNGKey(4), rcfg))
    back = params_to_reference(params_from_reference(tree, cfg, "cpu"), cfg)
    flat_t = ref.jax.tree_util.tree_flatten(tree)
    flat_b = ref.jax.tree_util.tree_flatten(back)
    assert flat_t[1] == flat_b[1]
    for a, b in zip(flat_t[0], flat_b[0], strict=True):
        # numpy has no bf16: the port's bf16 leaves are their bits, V2
        assert b.dtype == (np.dtype("V2") if a.dtype.name == "bfloat16"
                           else a.dtype) and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_bf16_lm_checkpoint_restores_in_both_packages(ref, tmp_path):
    """A bf16 LM tree, saved as ``--ckpt-dir`` saves it, needs no bf16
    numpy dtype: the reference's ``restore_checkpoint`` reads the same
    bits as from its own ``save_checkpoint``, and the port's restores
    the bf16 tensors."""
    from repro.checkpoint import restore_checkpoint as ref_restore
    from repro.checkpoint import save_checkpoint as ref_save
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.models.convert import _tree
    rcfg = dataclasses.replace(ref.get_config("qwen3_4b").reduced(),
                               dtype="bfloat16")
    cfg = dataclasses.replace(get_config("qwen3_4b").reduced(),
                              dtype="bfloat16")
    tree = ref.lm.init_model(ref.jax.random.PRNGKey(5), rcfg)
    params = params_from_reference(ref.jax.tree.map(np.array, tree), cfg,
                                   "cpu")
    save_checkpoint(str(tmp_path / "port"), 3,
                    params_to_reference(params, cfg))
    ref_save(str(tmp_path / "ref"), 3, tree)
    mine = ref_restore(str(tmp_path / "port"), tree)
    theirs = ref_restore(str(tmp_path / "ref"), tree)
    for a, b in zip(_leaves(mine), _leaves(theirs), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    like = _tree(ref.jax.tree.map(np.array, tree), torch.device("cpu"))
    back = restore_checkpoint(str(tmp_path / "port"), like)
    assert any(a.dtype == torch.bfloat16 for a in tree_leaves(back))
    for a, b in zip(tree_leaves(back), tree_leaves(like), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# the CLI: python -m repro_torch.launch.train --device cpu
# ---------------------------------------------------------------------------
def _run_cli(args, timeout=420):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--device", "cpu"] + args, capture_output=True,
                         text=True, env=env, timeout=timeout, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout)


GNN_FLAGS = ["--workload", "gnn", "--nodes", "800", "--k", "2", "--epochs",
             "8", "--hidden", "32"]


def test_train_cli_gnn_matches_reference(ref, tmp_path):
    """The reference's flags: its partition report, its report keys, one
    component and no isolated node a part; ``--ckpt-dir`` saves the
    stacked GCN parameters at step ``epochs``."""
    from repro.checkpoint import latest_step
    from repro.launch import train as ref_train
    rec = _run_cli(GNN_FLAGS + ["--ckpt-dir", str(tmp_path)])
    args = port_train.parser().parse_args(GNN_FLAGS)
    want = ref_train.train_gnn(args)
    assert set(rec) == set(want) | {"checkpoint"}
    assert rec["partition_quality"] == want["partition_quality"]
    assert rec["partitioner"] == want["partitioner"]
    assert rec["partition_quality"]["total_isolated"] == 0
    assert rec["partition_quality"]["max_components"] == 1
    assert 0 <= rec["results"]["test"] <= 1
    assert latest_step(str(tmp_path)) == 8


LM_FLAGS = ["--workload", "lm", "--arch", "qwen3_4b", "--reduced"]


def test_train_cli_lm_loss_falls():
    rec = _run_cli(LM_FLAGS + ["--steps", "4"])
    assert rec["last_loss"] < rec["first_loss"]
    assert {"workload", "arch", "steps", "first_loss", "last_loss",
            "tokens_per_s", "steady_tokens_per_s"} <= set(rec)
    assert rec["steps"] == len(rec["losses"]) == 4
    assert rec["tokens_per_s"] > 0 and rec["steady_tokens_per_s"] > 0


def test_train_cli_lm_checkpoint_restores_in_the_reference(ref, tmp_path):
    """The LM checkpoint is in the reference's stacked layout: its
    ``latest_step`` finds step ``steps`` and its ``restore_checkpoint``
    reads the trained parameters, bit for bit the port's own run's."""
    from repro.checkpoint import latest_step, restore_checkpoint
    rec = _run_cli(LM_FLAGS + ["--steps", "2", "--ckpt-dir", str(tmp_path)])
    assert rec["checkpoint"] == str(tmp_path)
    assert latest_step(str(tmp_path)) == 2
    rcfg = ref.get_config("qwen3_4b").reduced()
    like = ref.lm.init_model(ref.jax.random.PRNGKey(0), rcfg)
    restored = restore_checkpoint(str(tmp_path), like)
    _, state = port_train.run_lm(port_train.parser().parse_args(
        ["--device", "cpu"] + LM_FLAGS + ["--steps", "2"]))
    mine = params_to_reference(state["params"], state["cfg"])
    for got, want in zip(_leaves(restored), _leaves(mine), strict=True):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _steps_on(device, cfg, capture, steps=3):
    params = lm.init_model(cfg, device, seed=0)
    opt = adamw_init(params)
    batch = make_batch(cfg, 4, 64, seed=0, device=device)
    train = port_steps.make_train_step(cfg, lr=LR, device=device,
                                       capture=capture)
    losses = [train(params, opt, batch)[2].clone() for _ in range(steps)]
    return torch.stack(losses), params, opt, train


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_cuda_captured_train_step_equals_eager(cuda, remat):
    """3 captured steps (one graph: forward, remat's recomputation,
    backward, AdamW) bitwise equal to 3 eager ones."""
    cfg = dataclasses.replace(get_config("qwen3_4b").reduced(), remat=remat)
    lc, pc, oc, step = _steps_on(cuda, cfg, True)
    le, pe, oe, _ = _steps_on(cuda, cfg, False)
    assert step.compiles == 1
    assert torch.equal(lc, le)
    for a, b in zip(tree_leaves((pc, oc.mu, oc.nu, oc.step)),
                    tree_leaves((pe, oe.mu, oe.nu, oe.step))):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_reduced_training_matches_the_cpu(cuda):
    """4 steps on the card against the CPU from the same seeded weights
    (the generator draws on each device, so the weights come from the
    CPU): losses at 1e-4 relative, f32, no TF32."""
    cfg = get_config("qwen3_4b").reduced()
    params = lm.init_model(cfg, "cpu", seed=0)
    runs = []
    for device in ("cpu", cuda):
        p = tree_map(lambda x: x.to(device, copy=True), params)
        opt = adamw_init(p)
        batch = make_batch(cfg, 4, 64, seed=0, device=device)
        train = port_steps.make_train_step(cfg, lr=LR, device=device)
        runs.append([float(train(p, opt, batch)[2]) for _ in range(4)])
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-4)
    assert runs[1][-1] < runs[1][0]


@pytest.mark.cuda
def test_cuda_in_place_adamw_bitwise_equals_adamw_update(cuda):
    params, grads = _trees(0, [(300, 70), (70,)])
    params, grads = (tree_map(lambda x: x.to(cuda), t)
                     for t in (params, grads))
    mine = tree_map(torch.clone, params)
    state, my_state = adamw_init(params), adamw_init(mine)
    for _ in range(3):
        params, state = adamw_update(grads, state, params, 1e-2,
                                     weight_decay=0.01)
        adamw_update_(grads, my_state, mine, 1e-2, weight_decay=0.01)
    for a, b in zip(tree_leaves((params, state.mu, state.nu)),
                    tree_leaves((mine, my_state.mu, my_state.nu))):
        assert torch.equal(a, b)
