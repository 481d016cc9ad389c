"""Kernel D (single-token GQA decode attention) against the reference.

On the CPU the port's dispatch (``repro_torch.kernels.ops.flash_decode``)
runs the plain version, which is held against the reference's Pallas
kernel run in interpret mode (``repro.kernels.flash_decode``), one
sequence at a time, on the reference's five sweep cases in f32 and bf16 at
the reference's own tolerance (``tests/test_kernels.py::_tol``: 2e-5 in
f32, 2e-2 in bf16), with B = 2 and a different length in each row.

The split-K plan and log-sum-exp merge the CUDA kernel uses are held on
the CPU through an emulation in PyTorch (the stretches ``plan`` chooses,
each reduced on its own, then merged as ``flash_decode_merge`` does).
The tests marked ``cuda`` hold the kernel against the plain version on
the card and skip where there is none.
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_decode as kernel_d        # noqa: E402
from repro_torch.kernels import ops                             # noqa: E402

# the reference's sweep (tests/test_kernels.py): H, Hkv, D, S, length
SWEEP = [(8, 8, 64, 600, 600), (8, 2, 64, 1000, 777),
         (16, 1, 128, 2048, 1), (4, 4, 128, 512, 512),
         (32, 8, 128, 1537, 1111)]
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


def _emulate_split_k(q, k, v, filled, sms):
    """The CUDA kernel's algorithm in f32 PyTorch: the stretches ``plan``
    picks, each reduced to (m, l, acc) on its own, stretches wholly past
    ``filled`` skipped, then merged by log-sum-exp with acc / max(l,
    1e-30). Length 0 gives 0, as the kernel (and the TPU kernel) do."""
    b, s, hkv, d = k.shape
    h = q.shape[1]
    g = h // hkv
    splits, chunk = kernel_d.plan(b, s, h, hkv, d, sms)
    assert (splits - 1) * chunk < s <= splits * chunk
    out = torch.zeros((b, h, d))
    qs = q.float() * (1.0 / np.sqrt(np.float32(d)))
    for bi in range(b):
        end = min(max(int(filled[bi]), 0), s)
        used = min(splits, -(-end // chunk))
        for hi in range(h):
            parts = []
            for j in range(used):
                lo, hi_pos = j * chunk, min((j + 1) * chunk, end)
                kk = k[bi, lo:hi_pos, hi // g].float()
                vv = v[bi, lo:hi_pos, hi // g].float()
                logits = kk @ qs[bi, hi]
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


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("h,hkv,d,s", [(8, 2, 64, 1000), (32, 8, 128, 1537),
                                       (16, 1, 128, 2048)])
def test_split_k_merge_matches_plain(h, hkv, d, s, sms):
    """The kernel's plan and merge, emulated, agree with the plain version
    at lengths on and next to its stretch boundaries (and at 1: every
    stretch but the first is empty)."""
    splits, chunk = kernel_d.plan(3, s, h, hkv, d, sms)
    q, k, v = (torch.as_tensor(x, dtype=torch.float32)
               for x in _inputs(h, hkv, d, s, b=3, seed=s))
    for lengths in ([1, chunk, chunk + 1], [chunk - 1, s, s - 1]):
        filled = torch.tensor([min(max(x, 1), s) for x in lengths],
                              dtype=torch.int32)
        got = _emulate_split_k(q, k, v, filled, sms)
        expect = ops.flash_decode(q, k, v, filled)
        np.testing.assert_allclose(got.numpy(), expect.numpy(), rtol=2e-5,
                                   atol=2e-5)


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
       hkv=st.sampled_from([1, 2, 8, 20]), g=st.integers(1, 16),
       d=st.sampled_from([64, 128]))
def test_plan_covers_the_cache_in_whole_steps(b, s, hkv, g, d):
    splits, chunk = kernel_d.plan(b, s, hkv * g, hkv, d, 132)
    gmax = kernel_d.group_rows(g)
    step = kernel_d.WARPS * (32 // (d // 8)) * (4 if gmax <= 4 else 2)
    assert chunk % step == 0
    assert (splits - 1) * chunk < s <= splits * chunk
    assert chunk <= max(step, kernel_d.MAX_CHUNK)


def test_plan_fills_the_card_at_the_timed_shapes():
    # decode_32k per layer: 1,024 (b, kv head) pairs, stretches of 4,096
    assert kernel_d.plan(128, 32768, 32, 8, 128, 132) == (8, 4096)
    # long_500k's sliding ring: 8 pairs; 66 stretches asked for, rounded
    # up to whole 32-position steps: 64 of 128, 512 blocks on 132 SMs
    assert kernel_d.plan(1, 8192, 32, 8, 128, 132) == (64, 128)
    assert kernel_d.group_rows(4) == 4 and kernel_d.group_rows(16) == 8


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


@pytest.mark.cuda
def test_cuda_kernel_length_zero_gives_zero(cuda):
    got, _ = _card_case(8, 2, 64, 100, 2, torch.float32, [0, 5], cuda)
    assert torch.equal(got[0], torch.zeros_like(got[0]))


@pytest.mark.cuda
def test_cuda_kernel_refuses_what_it_cannot_take(cuda):
    q = torch.zeros((1, 4, 96), device=cuda)
    k = torch.zeros((1, 8, 2, 96), device=cuda)
    with pytest.raises(ValueError, match="D in"):
        kernel_d.launch(q, k, k, torch.ones(1, dtype=torch.int32,
                                            device=cuda))
