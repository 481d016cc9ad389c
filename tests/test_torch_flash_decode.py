"""Kernel D (single-token GQA decode attention) against the reference.

On the CPU the port's dispatch (``repro_torch.kernels.ops.flash_decode``)
runs the plain version, which is held against the reference's Pallas
kernel run in interpret mode (``repro.kernels.flash_decode``), one
sequence at a time, on the reference's five sweep cases and two at D 96
(phi-3-vision's head dim; G 4 and 1) in f32 and bf16 at the reference's
own tolerance (``tests/test_kernels.py::_tol``: 2e-5 in
f32, 2e-2 in bf16), with B = 2 and a different length in each row.

The CUDA kernel's arithmetic is held on the CPU through two emulations
in PyTorch, against the plain version: the f32 path's (the stretches
``plan`` chooses, each reduced on its own with the scale on the f32
logits, then merged by log-sum-exp in split order, as the last block of
a group does) at 2e-5, and the bf16 path's tensor-core rounding (64-long
tiles, each warp's 16 positions with their own running max, P rounded to
bf16 against it before P V, the warps and then the stretches merged) at
the bf16 tolerance 2e-2, at the sweep's shapes, G = 16 and a 32,768-long
row, and through a reduced ``qwen3_4b`` decode step in bf16 whose logits
are held at ``chip_smoke.py`` phase 9's 0.1 (max and rms). The tests
marked ``cuda`` hold the kernel against the plain version on the card
(and the bf16 kernel against its emulation) and skip where there is none.
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_decode as kernel_d        # noqa: E402
from repro_torch.kernels import ops                             # noqa: E402

# the reference's sweep (tests/test_kernels.py): H, Hkv, D, S, length;
# and D 96 (phi-3-vision's head dim) at G 4 and G 1
SWEEP = [(8, 8, 64, 600, 600), (8, 2, 64, 1000, 777),
         (16, 1, 128, 2048, 1), (4, 4, 128, 512, 512),
         (32, 8, 128, 1537, 1111), (8, 2, 96, 700, 613),
         (4, 4, 96, 520, 519)]
DTYPES = {"float32": dict(rtol=2e-5, atol=2e-5),
          "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _inputs(h, hkv, d, s, b=2, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, d)), rng.normal(size=(b, s, hkv, d)),
            rng.normal(size=(b, s, hkv, d)))


@pytest.fixture
def ref():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import flash_decode
    return jnp, flash_decode


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("h,hkv,d,s,length", SWEEP)
def test_plain_matches_pallas(ref, h, hkv, d, s, length, dtype):
    jnp, flash_decode = ref
    q, k, v = _inputs(h, hkv, d, s, seed=h * 131 + s)
    lengths = [length, max(1, length // 3)]
    jdt = getattr(jnp, dtype)
    expect = np.stack([np.asarray(flash_decode(
        jnp.asarray(q[i], jdt), jnp.asarray(k[i], jdt),
        jnp.asarray(v[i], jdt), jnp.asarray(lengths[i])), np.float32)
        for i in range(2)])
    tdt = getattr(torch, dtype)
    got = ops.flash_decode(torch.as_tensor(q, dtype=tdt),
                           torch.as_tensor(k, dtype=tdt),
                           torch.as_tensor(v, dtype=tdt),
                           torch.as_tensor(lengths, dtype=torch.int32))
    assert got.dtype == tdt and got.shape == (2, h, d)
    np.testing.assert_allclose(got.float().numpy(), expect, **DTYPES[dtype])


def test_plain_ignores_stale_cache():
    """Rows past ``filled`` must not move the result."""
    q, k, v = (torch.as_tensor(x, dtype=torch.float32)
               for x in _inputs(8, 2, 64, 300))
    filled = torch.tensor([100, 7], dtype=torch.int32)
    out1 = ops.flash_decode(q, k, v, filled)
    k2, v2 = k.clone(), v.clone()
    k2[:, 100:] = 1e4
    v2[:, 100:] = -1e4
    assert torch.equal(out1, ops.flash_decode(q, k2, v2, filled))


def _emulate_split_k(q, k, v, filled, sms, blocks_per_sm=2):
    """The CUDA kernel's f32 algorithm in f32 PyTorch: the stretches
    ``plan`` picks, each reduced to (m, l, acc) on its own with the scale
    applied to the f32 logits, stretches wholly past ``filled`` skipped,
    then merged by log-sum-exp in split order with acc / max(l, 1e-30).
    Length 0 gives 0, as the kernel (and the TPU kernel) do."""
    b, s, hkv, d = k.shape
    h = q.shape[1]
    g = h // hkv
    splits, chunk = kernel_d.plan(b, s, h, hkv, torch.float32, sms,
                                  blocks_per_sm)
    assert (splits - 1) * chunk < s <= splits * chunk
    out = torch.zeros((b, h, d))
    scale = d ** -0.5
    for bi in range(b):
        end = min(max(int(filled[bi]), 0), s)
        used = min(splits, -(-end // chunk))
        for hi in range(h):
            parts = []
            for j in range(used):
                lo, hi_pos = j * chunk, min((j + 1) * chunk, end)
                kk = k[bi, lo:hi_pos, hi // g].float()
                vv = v[bi, lo:hi_pos, hi // g].float()
                logits = (kk @ q[bi, hi].float()) * scale
                m = logits.max()
                p = torch.exp(logits - m)
                parts.append((m, p.sum(), p @ vv))
            if not parts:
                continue
            mx = max(m for m, _, _ in parts)
            acc = sum(a * torch.exp(m - mx) for m, _, a in parts)
            lsum = sum(l * torch.exp(m - mx) for m, l, _ in parts)
            out[bi, hi] = acc / torch.clamp(lsum, min=1e-30)
    return out


def _emulate_tensor_core(q, k, v, filled, sms=132, blocks_per_sm=2):
    """The CUDA kernel's bf16 algorithm in PyTorch, with its roundings: the
    logits are an f32 product of the bf16 inputs, scaled after it; each
    stretch is walked in 64-long tiles, of which each of 4 warps takes 16
    positions and keeps its own (m, l, acc); per tile, p = exp(s - m) is
    rounded to bf16 and both l and P V take the rounded p; then the warps
    merge by log-sum-exp, the stretches in split order, and the result
    acc / max(l, 1e-30) is rounded to bf16. Length 0 gives 0."""
    b, s, hkv, d = k.shape
    h = q.shape[1]
    g = h // hkv
    splits, chunk = kernel_d.plan(b, s, h, hkv, torch.bfloat16, sms,
                                  blocks_per_sm)
    tp = kernel_d.tile(torch.bfloat16)
    warps, wp = 4, tp // 4
    tiles = chunk // tp
    s_pad = splits * chunk
    kf = torch.zeros((b, s_pad, hkv, d))
    vf = torch.zeros((b, s_pad, hkv, d))
    kf[:, :s], vf[:, :s] = k.float(), v.float()
    out = torch.zeros((b, h, d))
    for bi in range(b):
        end = min(max(int(filled[bi]), 0), s)
        if end == 0:
            continue
        used = -(-end // chunk)
        valid = (torch.arange(s_pad) < end).reshape(splits, tiles, warps,
                                                    wp)
        logits = torch.einsum("hgd,shd->hgs",
                              q[bi].float().reshape(hkv, g, d), kf[bi])
        logits = (logits * d ** -0.5).reshape(hkv, g, splits, tiles, warps,
                                              wp)
        logits = torch.where(valid, logits, torch.tensor(-1e30))
        vt = vf[bi].permute(1, 0, 2).reshape(hkv, splits, tiles, warps, wp,
                                             d)
        m = torch.full((hkv, g, splits, warps), -1e30)
        l = torch.zeros((hkv, g, splits, warps))
        acc = torch.zeros((hkv, g, splits, warps, d))
        for t in range(tiles):
            st = logits[:, :, :, t]
            mx = torch.maximum(m, st.max(-1).values)
            alpha = torch.exp(m - mx)
            p = torch.where(valid[:, t], torch.exp(st - mx[..., None]),
                            torch.tensor(0.0))
            p = p.to(torch.bfloat16).float()
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "hgnwp,hnwpd->hgnwd", p, vt[:, :, t])
            m = mx
        mw = m.max(-1).values                       # the warps' merge
        e = torch.exp(m - mw[..., None])
        lw, aw = (l * e).sum(-1), (acc * e[..., None]).sum(-2)
        mw, lw, aw = mw[..., :used], lw[..., :used], aw[..., :used, :]
        e = torch.exp(mw - mw.max(-1, keepdim=True).values)
        lsum = (lw * e).sum(-1)                     # the stretches' merge
        a = (aw * e[..., None]).sum(-2)
        out[bi] = (a / torch.clamp(lsum, min=1e-30)[..., None]).reshape(h, d)
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("h,hkv,d,s", [(8, 2, 64, 1000), (32, 8, 128, 1537),
                                       (16, 1, 128, 2048)])
def test_split_k_merge_matches_plain(h, hkv, d, s, sms):
    """The kernel's f32 plan and merge, emulated, agree with the plain
    version at lengths on and next to its stretch boundaries (and at 1:
    every stretch but the first is empty)."""
    splits, chunk = kernel_d.plan(3, s, h, hkv, torch.float32, sms, 2)
    q, k, v = (torch.as_tensor(x, dtype=torch.float32)
               for x in _inputs(h, hkv, d, s, b=3, seed=s))
    for lengths in ([1, chunk, chunk + 1], [chunk - 1, s, s - 1]):
        filled = torch.tensor([min(max(x, 1), s) for x in lengths],
                              dtype=torch.int32)
        got = _emulate_split_k(q, k, v, filled, sms)
        expect = ops.flash_decode(q, k, v, filled)
        np.testing.assert_allclose(got.numpy(), expect.numpy(), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("h,hkv,d,s,length", SWEEP + [
    (32, 2, 128, 32768, 32768), (16, 1, 64, 4096, 2049)])
def test_tensor_core_rounding_matches_plain(h, hkv, d, s, length, sms):
    """The bf16 path's roundings, emulated, hold against the plain version
    at the bf16 tolerance, with lengths on and off tile and stretch
    boundaries (G = 16 in a 32,768-long row among them)."""
    q, k, v = (torch.as_tensor(x, dtype=torch.bfloat16)
               for x in _inputs(h, hkv, d, s, seed=h + s))
    filled = torch.tensor([length, max(1, length // 3)], dtype=torch.int32)
    got = _emulate_tensor_core(q, k, v, filled, sms)
    expect = ops.flash_decode(q, k, v, filled)
    assert got.dtype == expect.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), expect.float().numpy(),
                               **DTYPES["bfloat16"])


def test_lm_decode_through_tensor_core_rounding(monkeypatch):
    """A reduced ``qwen3_4b`` decode step in bf16 (G = 4), its attention
    once through the plain version and once through the bf16 path's
    emulation: logits within 0.1 of the largest logit (max difference)
    and 0.1 of their rms (rms difference), phase 9's bound on the card."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import attention
    from repro_torch.models.lm import (grow_cache, init_model, prefill_step,
                                       serve_step)
    cfg = dataclasses.replace(get_config("qwen3_4b").reduced(),
                              num_heads=8, num_kv_heads=2, dtype="bfloat16")
    params = init_model(cfg, "cpu", seed=0)
    tokens = torch.as_tensor(np.random.default_rng(5).integers(
        1, cfg.vocab_size, (2, 320)), dtype=torch.int32)
    lengths = torch.tensor([300, 131], dtype=torch.int32)
    with torch.no_grad():
        logits, cache, _ = prefill_step(params, cfg, {"tokens": tokens})
        cache = grow_cache(cache, 340)
        nxt = logits.argmax(-1).to(torch.int32)[:, None]
        ref, _ = serve_step(params, cfg, nxt, cache, lengths)
        monkeypatch.setattr(attention, "flash_decode",
                            lambda q, k, v, f: _emulate_tensor_core(
                                q, k, v, f, sms=132))
        got, _ = serve_step(params, cfg, nxt, cache, lengths)
    d, r = (got - ref).float(), ref.float()
    assert torch.isfinite(got).all()
    assert float(d.abs().max() / r.abs().max()) <= 0.1
    assert float(d.pow(2).mean().sqrt() / r.pow(2).mean().sqrt()) <= 0.1


def test_length_zero_kernel_gives_zero_plain_gives_mean():
    """The one place the two differ, as the reference's kernel and oracle
    do; the decode path always has ``filled >= 1``."""
    q, k, v = (torch.as_tensor(x, dtype=torch.float32)
               for x in _inputs(4, 2, 64, 40, b=1))
    filled = torch.zeros(1, dtype=torch.int32)
    assert torch.equal(_emulate_split_k(q, k, v, filled, 132),
                       torch.zeros(1, 4, 64))
    mean = v[0].mean(0).repeat_interleave(2, dim=0)
    torch.testing.assert_close(ops.flash_decode(q, k, v, filled)[0], mean,
                               rtol=1e-5, atol=1e-5)


@settings(database=None, derandomize=True, max_examples=200)
@given(b=st.integers(1, 256), s=st.integers(1, 600_000),
       hkv=st.sampled_from([1, 2, 8, 20]), g=st.integers(1, 40),
       dtype=st.sampled_from([torch.bfloat16, torch.float32]),
       blocks=st.integers(1, 4))
def test_plan_covers_the_cache_in_whole_steps(b, s, hkv, g, dtype, blocks):
    splits, chunk = kernel_d.plan(b, s, hkv * g, hkv, dtype, 132, blocks)
    step = kernel_d.tile(dtype)
    assert chunk % step == 0
    assert (splits - 1) * chunk < s <= splits * chunk
    assert splits <= kernel_d.MAX_SPLITS
    assert chunk <= max(step, kernel_d.MAX_CHUNK)


def test_plan_fills_the_card_at_the_timed_shapes():
    bf16, f32 = torch.bfloat16, torch.float32
    # decode_32k per layer: 1,024 (b, kv head) pairs, stretches of 4,096
    assert kernel_d.plan(128, 32768, 32, 8, bf16, 132, 2) == (8, 4096)
    # at B 16, 128 pairs: 17 stretches of 1,952, 2,176 blocks in 8 waves
    # of 264 (the rows' lengths differ: blocks past them exit at once)
    assert kernel_d.plan(16, 32768, 32, 8, f32, 132, 2) == (17, 1952)
    # long_500k's sliding ring: 8 pairs; a block for each of 132 SMs asks
    # for 17 stretches, rounded up to whole 64-position tiles: 16 of 512
    # (8 tiles each, the balance floor)
    assert kernel_d.plan(1, 8192, 32, 8, bf16, 132, 2) == (16, 512)
    # the serving run's largest bucket: 3 rows, cache 1,056: 6 stretches
    # of 3 tiles, 144 blocks
    assert kernel_d.plan(3, 1056, 32, 8, bf16, 132, 2) == (6, 192)
    assert kernel_d.plan(1, 288, 32, 8, bf16, 132, 2) == (5, 64)
    assert kernel_d.group_rows(4, bf16) == kernel_d.group_rows(16, bf16) \
        == 16
    assert kernel_d.group_rows(4, f32) == 4
    assert kernel_d.group_rows(5, f32) == 8
    assert kernel_d.group_rows(40, f32) == 16


def test_kernel_refuses_cpu_tensors():
    q, k, v = (torch.zeros(s) for s in ((1, 4, 64), (1, 8, 2, 64),
                                        (1, 8, 2, 64)))
    with pytest.raises(ValueError, match="CUDA"):
        kernel_d.launch(q, k, v, torch.ones(1, dtype=torch.int32))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _card_case(h, hkv, d, s, b, dtype, filled, dev, seed=0):
    q, k, v = (torch.as_tensor(x, dtype=dtype, device=dev)
               for x in _inputs(h, hkv, d, s, b=b, seed=seed))
    f = torch.as_tensor(filled, dtype=torch.int32, device=dev)
    before = kernel_d.launches
    got = kernel_d.launch(q, k, v, f)
    torch.cuda.synchronize()
    assert kernel_d.launches == before + 1
    return got.float(), kernel_d.plain(q, k, v, f).float()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("h,hkv,d,s,length", SWEEP + [
    (12, 1, 64, 700, 650), (6, 2, 128, 9000, 8999), (20, 20, 128, 300, 1)])
def test_cuda_kernel_matches_plain(cuda, h, hkv, d, s, length, dtype):
    lengths = [length, max(1, length // 3), 1, s]
    got, expect = _card_case(h, hkv, d, s, 4, getattr(torch, dtype),
                             lengths, cuda)
    # f32: the kernel sums in another order (and through a split merge)
    tol = DTYPES[dtype] if dtype == "bfloat16" else dict(rtol=3e-5,
                                                         atol=3e-5)
    torch.testing.assert_close(got, expect, **tol)


SERVING = [(3, 1056, [882, 677, 556]), (2, 544, [324, 360]),
           (1, 288, [137]), (2, 160, [104, 80])]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,s,filled", SERVING)
def test_cuda_kernel_at_the_serving_shapes(cuda, b, s, filled, dtype):
    """``qwen3_4b``'s layer shape (H 32, Hkv 8, D 128) at the serving run's
    buckets: its rows' first-step lengths in caches of bucket + 32."""
    got, expect = _card_case(32, 8, 128, s, b, getattr(torch, dtype),
                             filled, cuda, seed=s)
    tol = DTYPES[dtype] if dtype == "bfloat16" else dict(rtol=3e-5,
                                                         atol=3e-5)
    torch.testing.assert_close(got, expect, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("g", [1, 4, 16])
def test_cuda_kernel_group_sizes(cuda, g, dtype):
    """G = 1, 4 and 16 (one block's rows in bf16) over a 32,768-long cache,
    with lengths on and off tile and stretch boundaries."""
    s = 32768
    got, expect = _card_case(2 * g, 2, 128, s, 4, getattr(torch, dtype),
                             [s, 4096, 4097, 63], cuda, seed=g)
    tol = DTYPES[dtype] if dtype == "bfloat16" else dict(rtol=3e-5,
                                                         atol=3e-5)
    torch.testing.assert_close(got, expect, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("g", [1, 4, 8, 16])
def test_cuda_kernel_at_head_dim_96(cuda, g, dtype):
    """D 96 at phi-3-vision's decode shape (B 4, a 1,056-long cache, 32
    query heads) for G = 1 (its own), 4, 8 and 16: each row count of the
    f32 path (4, 8, 16) and the bf16 path's swizzle, with lengths on and
    off tile and stretch boundaries."""
    got, expect = _card_case(32, 32 // g, 96, 1056, 4, getattr(torch, dtype),
                             [1056, 577, 64, 1], cuda, seed=g)
    tol = DTYPES[dtype] if dtype == "bfloat16" else dict(rtol=3e-5,
                                                         atol=3e-5)
    torch.testing.assert_close(got, expect, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("h,hkv,d,s,length", [
    (32, 8, 128, 1056, 882), (32, 2, 128, 32768, 32768),
    (16, 1, 64, 4096, 2049), (32, 32, 96, 1056, 882)])
def test_cuda_bf16_kernel_matches_its_emulation(cuda, h, hkv, d, s, length):
    """The bf16 kernel against the CPU emulation of its roundings: they
    differ by the f32 sums' order only, within one bf16 rounding."""
    q, k, v = (torch.as_tensor(x, dtype=torch.bfloat16, device=cuda)
               for x in _inputs(h, hkv, d, s, seed=7))
    f = torch.tensor([length, max(1, length // 3)], dtype=torch.int32,
                     device=cuda)
    got = kernel_d.launch(q, k, v, f).float().cpu()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    splits, chunk = kernel_d.plan_of(q, k)
    emu = None
    for blocks in (1, 2, 3, 4, 8):      # the occupancy the kernel planned at
        if kernel_d.plan(2, s, h, hkv, torch.bfloat16, sms, blocks) == \
                (splits, chunk):
            emu = _emulate_tensor_core(q.cpu(), k.cpu(), v.cpu(), f.cpu(),
                                       sms, blocks).float()
            break
    assert emu is not None
    torch.testing.assert_close(got, emu, rtol=1e-2, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_kernel_is_bitwise_repeatable(cuda, dtype):
    """Two calls give bitwise-equal outputs: the last block of a group
    merges the stretches in split order, whichever block arrives last."""
    s = 8192
    q, k, v = (torch.as_tensor(x, dtype=getattr(torch, dtype), device=cuda)
               for x in _inputs(32, 8, 128, s, b=3, seed=11))
    f = torch.tensor([s, 5000, 77], dtype=torch.int32, device=cuda)
    first = kernel_d.launch(q, k, v, f)
    for _ in range(3):
        assert torch.equal(first, kernel_d.launch(q, k, v, f))


@pytest.mark.cuda
def test_cuda_kernel_allocates_only_its_output(cuda):
    """After a shape's first call (plan and workspace), a call allocates
    one block: its output."""
    q, k, v = (torch.as_tensor(x, dtype=torch.bfloat16, device=cuda)
               for x in _inputs(32, 8, 128, 1056, b=3))
    f = torch.tensor([882, 677, 556], dtype=torch.int32, device=cuda)
    kernel_d.launch(q, k, v, f)
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats(cuda)["allocation.all.allocated"]
    kernel_d.launch(q, k, v, f)
    after = torch.cuda.memory_stats(cuda)["allocation.all.allocated"]
    assert after - before == 1


@pytest.mark.cuda
def test_cuda_kernel_length_zero_gives_zero(cuda):
    got, _ = _card_case(8, 2, 64, 100, 2, torch.float32, [0, 5], cuda)
    assert torch.equal(got[0], torch.zeros_like(got[0]))


@pytest.mark.cuda
def test_cuda_kernel_refuses_what_it_cannot_take(cuda):
    q = torch.zeros((1, 4, 80), device=cuda)
    k = torch.zeros((1, 8, 2, 80), device=cuda)
    with pytest.raises(ValueError, match="D in"):
        kernel_d.launch(q, k, k, torch.ones(1, dtype=torch.int32,
                                            device=cuda))
