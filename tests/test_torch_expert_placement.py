"""The port's Leiden-Fusion expert placement
(``repro_torch.core.expert_placement``) against the reference's
(``repro.core.expert_placement``, numpy only).

* The reference's own two cases (``tests/test_substrates.py``), run on
  the port.
* The port's co-activation graph and placement byte-equal to the
  reference's on 3 seeded traces.
* ``apply_placement_to_params`` on the port's per-layer MoE tensors and
  on a stacked numpy tree, as the reference indexes it.
* A reduced MoE model (qwen2-moe, f32) with every MoE layer permuted by a
  placement gives the unpermuted logits within 1e-6 (abs + rel) on the
  CPU: the router's columns move with the experts, and only the order of
  prefill's sum over experts changes (measured 1.7e-6 abs at logits of
  order 2, a few f32 ulps).
* The example twin's traces and comparison at a small size.
"""
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config                      # noqa: E402
from repro_torch.core.expert_placement import (                 # noqa: E402
    apply_placement_to_params, coactivation_graph, contiguous_placement,
    lf_expert_placement, placement_cost, router_top_k)
from repro_torch.models import lm                               # noqa: E402
from repro_torch.models.layers import apply_norm                # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (experts, shards, top-k, tokens, planted blocks, seed)
TRACES = [(16, 4, 2, 600, 4, 0), (24, 3, 3, 900, 6, 1),
          (32, 8, 4, 800, 8, 2)]


def clustered_trace(num_experts, k, tokens, blocks, seed):
    """Tokens pick their ``k`` experts from one of ``blocks`` shuffled
    expert blocks, with one uniform pick in 5 (ties the blocks)."""
    rng = np.random.default_rng(seed)
    groups = rng.permutation(num_experts).reshape(blocks, -1)
    out = np.zeros((tokens, k), dtype=np.int64)
    for t in range(tokens):
        g = groups[rng.integers(blocks)]
        pick = list(rng.choice(g, size=k, replace=False))
        if rng.random() < 0.2:
            e = int(rng.integers(num_experts))
            if e not in pick:
                pick[-1] = e
        out[t] = pick
    return out


def test_lf_expert_placement_balanced_and_better():
    """The reference's case: planted blocks of 4 among 16 experts."""
    rng = np.random.default_rng(0)
    num_experts, shards, k = 16, 4, 2
    blocks = np.arange(num_experts).reshape(4, 4)
    rng.shuffle(blocks.reshape(-1))
    trace = np.zeros((4000, k), dtype=np.int64)
    for t in range(4000):
        b = blocks[rng.integers(4)]
        trace[t] = rng.choice(b, size=k, replace=False)
    lf = lf_expert_placement(trace, num_experts, shards)
    assert np.bincount(lf, minlength=shards).tolist() == [4, 4, 4, 4]
    naive = contiguous_placement(num_experts, shards)
    c_lf = placement_cost(trace, lf)["mean_shards_per_token"]
    c_naive = placement_cost(trace, naive)["mean_shards_per_token"]
    assert c_lf <= c_naive
    assert c_lf < 1.1


def test_apply_placement_permutes_experts():
    """The reference's case, on numpy arrays."""
    e, d, f = 6, 4, 8
    params = {"router": np.arange(d * e).reshape(d, e).astype(np.float32),
              "w_gate": np.arange(e * d * f).reshape(e, d, f).astype(
                  np.float32)}
    placement = np.array([1, 0, 1, 0, 1, 0])
    out, perm = apply_placement_to_params(params, placement)
    assert (placement[perm] == np.array([0, 0, 0, 1, 1, 1])).all()
    np.testing.assert_array_equal(out["w_gate"][0], params["w_gate"][perm[0]])
    np.testing.assert_array_equal(out["router"][:, 0],
                                  params["router"][:, perm[0]])


@pytest.mark.parametrize("case", TRACES, ids=[f"e{c[0]}_s{c[1]}_k{c[2]}"
                                              for c in TRACES])
def test_placement_byte_equal_to_reference(case):
    """The co-activation graph's CSR, the LF placement, the contiguous
    one and both costs: the reference's, byte for byte."""
    from repro.core import expert_placement as ref
    e, shards, k, tokens, blocks, seed = case
    trace = clustered_trace(e, k, tokens, blocks, seed)
    g, rg = coactivation_graph(trace, e), ref.coactivation_graph(trace, e)
    for name in ("indptr", "indices", "edge_weight", "self_weight"):
        a, b = getattr(g, name), getattr(rg, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    for v in range(e):
        assert g.neighbor_weights(v).tobytes() == \
            rg.neighbor_weights(v).tobytes()
    mine = lf_expert_placement(trace, e, shards, seed=seed)
    theirs = ref.lf_expert_placement(trace, e, shards, seed=seed)
    assert mine.dtype == theirs.dtype and mine.tobytes() == theirs.tobytes()
    assert np.bincount(mine, minlength=shards).tolist() == \
        [e // shards] * shards
    naive = contiguous_placement(e, shards)
    assert naive.tobytes() == ref.contiguous_placement(e, shards).tobytes()
    for p in (mine, naive):
        assert placement_cost(trace, p) == ref.placement_cost(trace, p)


def test_rebalance_moves_least_attached_like_reference():
    """An overfull start (every expert on shard 0) rebalanced to exact
    sizes, move for move as the reference does."""
    from repro.core import expert_placement as ref
    from repro_torch.core import expert_placement as port
    trace = clustered_trace(12, 2, 300, 3, 4)
    start = np.zeros(12, dtype=np.int64)
    mine = port._rebalance(port.coactivation_graph(trace, 12), start, 3, 4)
    theirs = ref._rebalance(ref.coactivation_graph(trace, 12), start, 3, 4)
    assert mine.tobytes() == theirs.tobytes()
    assert (start == 0).all()           # the input is left as it was


def test_apply_placement_on_port_tensors_and_stacked_numpy():
    """Per-layer tensors: axis 0 of the expert stacks, the router's last
    axis, the shared experts untouched. A stacked ``[L, E, ...]`` numpy
    leaf is permuted on its axis 1, as the reference indexes it."""
    from repro.core import expert_placement as ref
    cfg = get_config("qwen2_moe_a2p7b").reduced(num_experts=4)
    p = lm.init_model(cfg, "cpu", seed=1)["layers"][0]["ffn"]
    placement = np.array([1, 0, 0, 1])
    out, perm = apply_placement_to_params(p, placement)
    assert perm.tolist() == [1, 2, 0, 3]
    for name in ("w_gate", "w_up", "w_out"):
        assert torch.equal(out[name], p[name][torch.as_tensor(perm)])
    assert torch.equal(out["router"], p["router"][:, torch.as_tensor(perm)])
    assert out["shared"] is p["shared"]
    stacked = {"w_up": np.arange(2 * 4 * 3 * 5, dtype=np.float32)
               .reshape(2, 4, 3, 5),
               "router": np.arange(2 * 3 * 4, dtype=np.float32)
               .reshape(2, 3, 4)}
    mine, _ = apply_placement_to_params(stacked, placement)
    theirs, _ = ref.apply_placement_to_params(stacked, placement)
    for name in stacked:
        assert mine[name].tobytes() == theirs[name].tobytes()


def test_permuted_model_gives_the_same_logits():
    """Every MoE layer of a reduced qwen2-moe (f32, 8 experts top-2)
    permuted by an LF placement of its own router trace: prefill and a
    decode step give the unpermuted model's logits within 1e-6 (abs +
    rel), and the trace read through ``router_top_k`` is the router's
    choice."""
    cfg = get_config("qwen2_moe_a2p7b").reduced(num_experts=8)
    params = lm.init_model(cfg, "cpu", seed=2)
    tokens = torch.as_tensor(np.random.default_rng(5).integers(
        1, cfg.vocab_size, (2, 16)), dtype=torch.int32)
    lp = params["layers"][0]
    h = apply_norm(lp["ln2"], params["embed"][tokens.long()])
    trace = router_top_k(lp["ffn"], cfg, h)
    assert trace.shape == (32, cfg.top_k) and trace.dtype == np.int64
    want = torch.topk(torch.softmax(h.float() @ lp["ffn"]["router"], -1),
                      cfg.top_k).indices
    assert (trace == want.reshape(-1, cfg.top_k).numpy()).all()
    placement = lf_expert_placement(trace, cfg.num_experts, 4)
    permuted = dict(params, layers=[
        dict(layer, ffn=apply_placement_to_params(layer["ffn"],
                                                  placement)[0])
        for layer in params["layers"]])
    assert not torch.equal(permuted["layers"][1]["ffn"]["w_up"],
                           params["layers"][1]["ffn"]["w_up"])
    runs = []
    with torch.no_grad():
        for p in (params, permuted):
            logits, cache, lens = lm.prefill_step(p, cfg, {"tokens": tokens})
            cache = lm.grow_cache(cache, 20)
            step, _ = lm.serve_step(p, cfg, tokens[:, :1], cache, lens)
            runs.append((logits, step))
    for a, b in zip(*runs):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_example_twin_at_a_small_size(capsys):
    """``examples/moe_expert_placement_torch.py``'s synthetic trace is the
    reference example's, draw for draw; its real trace (3 train steps) and
    comparison run on the CPU."""
    path = os.path.join(ROOT, "examples", "moe_expert_placement_torch.py")
    spec = importlib.util.spec_from_file_location("placement_example", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    ref_path = os.path.join(ROOT, "examples", "moe_expert_placement.py")
    spec = importlib.util.spec_from_file_location("ref_example", ref_path)
    ref_example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_example)
    kwargs = dict(num_experts=24, top_k=3, tokens=500, num_topics=4)
    trace = example.synthetic_router_trace(**kwargs)
    assert trace.tobytes() == ref_example.synthetic_router_trace(
        **kwargs).tobytes()
    naive, lf = example.compare(trace, 24, 4, p90=True)
    assert lf <= naive
    real, e = example.real_router_trace(torch.device("cpu"),
                                        tokens_per_topic=8, num_topics=4,
                                        steps=3)
    assert e == 16 and real.shape == (4 * 2 * 8, 2)
    assert real.min() >= 0 and real.max() < e
    example.compare(real, e, 4)
    out = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0].strip() for line in out] == [
        "contiguous", "leiden_fusion"] * 2
