"""The port's compiled steps (``repro_torch.graphs``): ``CapturedStep``'s
static-buffer plumbing and ``CompileLog``.

Pins, on the CPU:

* ``CompileLog`` against the reference's ``repro.serving.CompileLog`` on
  the same call sequences (warmup buckets, ``mark_steady``, repeats, new
  shapes after it): equal ``stats()`` and equal ``serving.compiles.*``
  counters; the reference's programs are fresh ``jax.jit`` functions,
  the port's fresh ``CapturedStep`` objects;
* the plumbing equals the plain call bitwise over 3 steps, dropout 0.3
  where the step has dropout: the stacked local step, the sequential step
  (two partitions through one signature), sync, stale(2)'s three steps in
  exchange, stale, frozen order, and the classifier step; the whole
  training loops too (losses, parameters, table, exchanges, compiles);
* launch accounting: with the card's capture emulated on the CPU (a graph
  that records nothing and replays nothing), the counters a replay moves
  (kernel launches, exchanges) advance per call exactly as eager calls
  move them, and warm-up and capture add nothing; the counters replayed
  are ``ops.COUNTERS``, which names every counter a kernel module keeps;
* the reduced-config LM report's ``decode_compiles`` equals the
  reference's ``serve`` on the same arguments.

The ``cuda`` cases skip here (a fixture decides): on the card the
captured and eager paths give bitwise-equal losses, parameters, tables,
served answers and decoded tokens, replays advance the dropout masks, and
a capture that cannot be made raises. JAX is imported only inside the
tests that call the reference, so the ``cuda`` cases need none.
"""
import argparse
import contextlib
import types

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro_torch import core, graphs, obs                      # noqa: E402
from repro_torch.gnn.halo import (capture_steps,               # noqa: E402
                                  make_stale_train_steps, train_stale,
                                  train_sync)
from repro_torch.gnn.infer import (gather_partition_tensors,   # noqa: E402
                                   init_partition_models, partition_params)
from repro_torch.gnn.model import GNNConfig, init_mlp         # noqa: E402
from repro_torch.gnn.train import (dropout_generators,         # noqa: E402
                                   local_train_step, make_classifier_step,
                                   make_local_step, make_stacked_step,
                                   stacked_train_step, train_classifier,
                                   train_local)
from repro_torch.kernels import autotune, csr_aggregate        # noqa: E402
from repro_torch.kernels import exchange, ops                  # noqa: E402
from repro_torch.optim import adamw_init                       # noqa: E402
from repro_torch.tree import tree_leaves                       # noqa: E402

CPU = torch.device("cpu")
K, LR, STEPS = 4, 1e-2, 3


@pytest.fixture(autouse=True)
def _obs_isolation():
    obs.reset()
    yield
    obs.reset()


@pytest.fixture(scope="module")
def graph():
    """arxiv-like at 400 nodes, Leiden-Fusion k = 4, Repli, with its halo
    plan (the sync and stale tests' graph)."""
    ds = core.make_arxiv_like(n=400, feature_dim=8, num_classes=4, seed=3)
    labels = core.leiden_fusion(ds.graph, K, alpha=0.3)
    batch = core.build_partition_batch(ds.graph, labels, scheme="repli")
    return ds, batch, core.build_halo_exchange(ds.graph, labels, batch)


def _cfg(dropout=0.3):
    return GNNConfig(kind="gcn", feature_dim=8, hidden_dim=16, embed_dim=16,
                     num_layers=2, dropout=dropout)


def _params(ds, device=CPU):
    return init_partition_models(_cfg(), ds.num_classes, K,
                                 torch.Generator().manual_seed(0), device)


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _gen_states(gens):
    return [g.get_state() for g in gens]


# ---------------------------------------------------------------------------
# CompileLog against the reference's
# ---------------------------------------------------------------------------
@settings(database=None, derandomize=True, max_examples=12, deadline=None)
@given(warm=st.lists(st.sampled_from([1, 2, 4, 8]), min_size=1, max_size=6),
       steady=st.lists(st.tuples(st.sampled_from(["classify", "inductive"]),
                                 st.sampled_from([1, 2, 4, 8, 16])),
                       max_size=6))
def test_compile_log_matches_reference(warm, steady):
    """The same calls through both logs: warmup's buckets for two
    programs, ``mark_steady``, then repeats and new shapes."""
    jax = pytest.importorskip("jax")
    from repro import obs as ref_obs
    from repro.serving import CompileLog as RefLog
    from repro_torch.serving import CompileLog

    def programs_ref():
        # fresh functions: a jit cache of their own
        return {"classify": jax.jit(lambda x: x * 2.0),
                "inductive": jax.jit(lambda x: x.sum(axis=-1))}

    def programs_port():
        return {"classify": graphs.CapturedStep(lambda x: x * 2.0, CPU),
                "inductive": graphs.CapturedStep(lambda x: x.sum(dim=-1),
                                                 CPU)}

    def drive(log, progs, zeros):
        for b in warm:
            for name in ("classify", "inductive"):
                log.call(name, progs[name], zeros(b))
        log.mark_steady()
        for name, b in steady:
            log.call(name, progs[name], zeros(b))
        return log.stats()

    obs.reset()
    ref_obs.reset()
    try:
        want = drive(RefLog(), programs_ref(),
                     lambda b: np.zeros((b, 3), np.float32))
        ref_counters = ref_obs.registry().snapshot(kinds=("counter",))
    finally:
        ref_obs.reset()
    got = drive(CompileLog(), programs_port(), lambda b: torch.zeros(b, 3))
    assert got == want
    assert obs.registry().snapshot(kinds=("counter",)) == ref_counters
    assert got["steady_state_recompiles"] == len(
        {(n, b) for n, b in steady if b not in warm})


def test_compile_log_counts_a_plain_function_by_shape():
    """Where a program is not a ``CapturedStep`` (an eager run), a compile
    is a new argument shape, the reference's fallback."""
    from repro_torch.serving import CompileLog
    log = CompileLog()
    for b in (1, 2, 1):
        log.call("classify", lambda x: x, torch.zeros(b, 2))
    log.mark_steady()
    log.call("classify", lambda x: x, torch.zeros(4, 2))
    assert log.stats() == {"warm_compiles": {"classify": 2},
                           "steady_compiles": {"classify": 1},
                           "steady_state_recompiles": 1}


# ---------------------------------------------------------------------------
# the plumbing on the CPU equals the plain call
# ---------------------------------------------------------------------------
def test_stacked_step_plumbing_is_the_plain_call(graph):
    ds, batch, _ = graph
    tensors = gather_partition_tensors(ds, batch, CPU)
    step = make_stacked_step(tensors, _cfg(), ds.multilabel, LR, CPU)
    assert isinstance(step, graphs.CapturedStep)
    params = _params(ds)
    p_a, o_a = params, adamw_init(params, stacked=True)
    p_b, o_b = params, adamw_init(params, stacked=True)
    g_a, g_b = dropout_generators(0, K, CPU), dropout_generators(0, K, CPU)
    losses = []
    for _ in range(STEPS):
        p_a, o_a, l_a = step(p_a, o_a, g_a)
        p_b, o_b, l_b = stacked_train_step(p_b, o_b, tensors, _cfg(),
                                           ds.multilabel, LR, g_b)
        assert torch.equal(l_a, l_b)
        assert _equal(p_a, p_b) and _equal(tuple(o_a), tuple(o_b))
        assert all(torch.equal(x, y) for x, y in zip(_gen_states(g_a),
                                                      _gen_states(g_b)))
        losses.append(l_a.clone())
    assert step.compiles == 1
    assert not torch.equal(losses[0], losses[1])     # training moved
    assert _equal(params, _params(ds))               # inputs untouched


def test_sequential_step_plumbing_is_the_plain_call(graph):
    """One signature serves two partitions' tensors (padding gives them
    one shape), each copied into the static inputs."""
    ds, batch, _ = graph
    step = make_local_step(_cfg(), ds.multilabel, LR, CPU)
    gens = dropout_generators(0, K, CPU)
    plain_gens = dropout_generators(0, K, CPU)
    params = _params(ds)
    for p in (0, 1):
        t_p = gather_partition_tensors(ds, batch, CPU, only=p)
        p_a = p_b = partition_params(params, p)
        o_a = o_b = adamw_init(p_a)
        for _ in range(STEPS):
            p_a, o_a, l_a = step(p_a, o_a, t_p, gens[p])
            p_b, o_b, l_b = local_train_step(p_b, o_b, t_p, 0, _cfg(),
                                             ds.multilabel, LR,
                                             plain_gens[p])
            assert torch.equal(l_a, l_b) and _equal(p_a, p_b)
    assert step.compiles == 1


def test_halo_steps_plumbing_is_the_plain_call(graph):
    """Sync's step three times, then stale(2)'s three steps in exchange,
    stale, frozen order, through one shared pool."""
    ds, batch, halo = graph
    tensors = gather_partition_tensors(ds, batch, CPU)
    plan = exchange.plan(halo, batch.n_pad, CPU)
    plain = make_stale_train_steps(_cfg(), plan, ds.multilabel, LR)
    captured = capture_steps(plain, CPU)
    params = _params(ds)
    state_a = state_b = (params, adamw_init(params, stacked=True))
    g_a, g_b = dropout_generators(0, K, CPU), dropout_generators(0, K, CPU)

    def both(kind, *extra):
        nonlocal state_a, state_b
        a = captured[kind](*state_a, tensors, g_a, *extra[:1])
        b = plain[kind](*state_b, tensors, g_b, *extra[1:])
        state_a, state_b = a[:2], b[:2]
        assert torch.equal(a[2], b[2])
        assert _equal(a[0], b[0]) and _equal(tuple(a[1]), tuple(b[1]))
        return a, b
    for _ in range(STEPS):                          # sync
        a, b = both("exchange")
    caches = (a[3], b[3])
    assert all(torch.equal(x, y) for x, y in zip(*caches))
    both("stale", *caches)
    both("frozen")
    assert {k: s.compiles for k, s in captured.items()} == {
        "exchange": 1, "stale": 1, "frozen": 1}


def test_classifier_step_plumbing_is_the_plain_call(graph):
    ds, _, _ = graph
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((ds.graph.n, 16), generator=gen)
    y = torch.as_tensor(ds.labels, dtype=torch.int64)
    tr = torch.as_tensor(ds.train_mask, dtype=torch.float32)
    step = make_classifier_step(x, y, tr, False, LR)
    eager = make_classifier_step(x, y, tr, False, LR, capture=False)
    assert not isinstance(eager, graphs.CapturedStep)
    params = init_mlp(torch.Generator().manual_seed(0), 16, 32,
                      ds.num_classes, CPU)
    a = b = (params, adamw_init(params))
    for _ in range(STEPS):
        a, b = step(*a), eager(*b)
        assert _equal(a[0], b[0]) and _equal(tuple(a[1]), tuple(b[1]))
    assert step.compiles == 1


@pytest.mark.parametrize("mode", ["local", "sequential", "sync", "stale"])
def test_training_loops_captured_equal_eager(graph, mode):
    """Each trainer through its captured steps (the CPU plumbing) against
    ``capture=False``: losses, parameters, table and exchanges bitwise;
    the compiles the reference's jits would make."""
    ds, batch, halo = graph
    runs = []
    for capture in (True, False):
        kw = dict(epochs=STEPS, lr=LR, seed=0, device="cpu",
                  params=_params(ds), capture=capture)
        if mode == "sync":
            runs.append(train_sync(ds, batch, halo, _cfg(), **kw))
        elif mode == "stale":
            runs.append(train_stale(ds, batch, halo, _cfg(), sync_period=2,
                                    **kw))
        else:
            runs.append(train_local(ds, batch, _cfg(),
                                    sequential=mode == "sequential", **kw))
    cap, eager = runs
    assert np.array_equal(cap.losses, eager.losses)
    assert _equal(cap.params, eager.params)
    assert torch.equal(cap.embeddings, eager.embeddings)
    if mode in ("sync", "stale"):
        assert np.array_equal(cap.exchanges, eager.exchanges)
    want = {"local": {"local": 1}, "sequential": {"sequential": 1},
            "sync": {"exchange": 1, "stale": 0, "frozen": 0},
            "stale": {"exchange": 1, "stale": 1, "frozen": 0}}[mode]
    assert cap.compiles == want
    assert eager.compiles == {k: 0 for k in want}


def test_train_classifier_captured_equals_eager(graph):
    ds, _, _ = graph
    table = torch.randn((ds.graph.n, 16),
                        generator=torch.Generator().manual_seed(2))
    out = [train_classifier(ds, table, hidden=32, epochs=5, seed=0,
                            capture=capture) for capture in (True, False)]
    assert out[0][0] == out[1][0]
    assert _equal(out[0][1], out[1][1])


def test_borrowed_arguments_are_not_copied():
    """A borrowed tensor is the step's own input (an in-place write
    reaches the caller); a copied one is not."""
    def write(buf, x):
        buf.add_(x)
        return buf * 1.0
    step = graphs.CapturedStep(write, CPU, borrow=(0,))
    buf = torch.zeros(3)
    step(buf, torch.ones(3))
    step(buf, torch.ones(3))
    assert torch.equal(buf, torch.full((3,), 2.0))
    copied = graphs.CapturedStep(write, CPU)
    other = torch.zeros(3)
    copied(other, torch.ones(3))
    assert torch.equal(other, torch.zeros(3))


def test_signature_keys_shapes_dtypes_and_static_leaves():
    step = graphs.CapturedStep(lambda x, scale: x * scale, CPU)
    step(torch.ones(2), 2.0)
    step(torch.zeros(2), 2.0)
    assert step.compiles == 1
    step(torch.ones(3), 2.0)
    step(torch.ones(2, dtype=torch.float64), 2.0)
    step(torch.ones(2), 3.0)
    assert step.compiles == 4


# ---------------------------------------------------------------------------
# launch accounting over replays (capture emulated on the CPU)
# ---------------------------------------------------------------------------
class _FakeGraph:
    """A graph that records nothing and replays nothing: the outputs stay
    what the capture's run made, and only the counters move on replay."""
    registered = 0

    def register_generator_state(self, gen):
        _FakeGraph.registered += 1

    def replay(self):
        pass


@contextlib.contextmanager
def _emulated_card(monkeypatch):
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
    yield


def _on_card(step):
    step.cuda = True
    return step


def test_replays_move_the_launch_counters_as_eager_calls(monkeypatch):
    def fn(x):
        csr_aggregate.launches += 2
        exchange.calls += 1
        exchange.launches += 1
        return x * 2.0
    ops.reset_launch_counts()
    calls0 = exchange.calls
    for _ in range(5):
        fn(torch.ones(2))
    eager = (ops.launch_counts(), exchange.calls - calls0)
    ops.reset_launch_counts()
    calls0 = exchange.calls
    with _emulated_card(monkeypatch):
        step = _on_card(graphs.CapturedStep(fn, CPU))
        outs = [step(torch.ones(2)) for _ in range(5)]
    assert (ops.launch_counts(), exchange.calls - calls0) == eager
    assert eager[0]["csr_aggregate"] == 10 and eager[1] == 5
    assert step.compiles == 1
    assert all(o is outs[0] for o in outs)      # the static outputs


def test_replayed_sync_epochs_count_their_exchanges(graph, monkeypatch):
    """The sync step's exchanges per call through the emulated capture:
    one per layer, as the eager step counts them (``exchanges[e]``)."""
    ds, batch, halo = graph
    tensors = gather_partition_tensors(ds, batch, CPU)
    plan = exchange.plan(halo, batch.n_pad, CPU)
    steps = make_stale_train_steps(_cfg(), plan, ds.multilabel, LR)
    params = _params(ds)
    opt = adamw_init(params, stacked=True)
    gens = dropout_generators(0, K, CPU)
    before = exchange.calls
    steps["exchange"](params, opt, tensors, gens)
    per_step = exchange.calls - before
    assert per_step == _cfg().num_layers
    _FakeGraph.registered = 0
    with _emulated_card(monkeypatch):
        step = _on_card(capture_steps(steps, CPU)["exchange"])
        counts = []
        for _ in range(STEPS):
            before = exchange.calls
            step(params, opt, tensors, gens)
            counts.append(exchange.calls - before)
    assert counts == [per_step] * STEPS
    assert _FakeGraph.registered == K        # one generator per partition


# ---------------------------------------------------------------------------
# the LM report
# ---------------------------------------------------------------------------
def test_lm_decode_compiles_equal_the_reference():
    """Reduced qwen3_4b, 6 requests over several prompt buckets: one decode
    graph per bucket, the reference's one decode compile per bucket."""
    pytest.importorskip("jax")
    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve as port_serve
    args = argparse.Namespace(arch="qwen3_4b", reduced=True, requests=6,
                              min_prompt=5, max_prompt=70, max_new=2,
                              seed=1, device="cpu")
    want = ref_serve.serve(args)
    got = port_serve.serve(args)
    assert got["prefill_buckets"] == want["prefill_buckets"]
    assert got["decode_compiles"] == want["decode_compiles"] == len(
        want["prefill_buckets"]) > 1
    assert port_serve.serve(args, capture=False)["decode_compiles"] == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda(tmp_path, monkeypatch):
    """The card, with an empty autotune cache of the test's own."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune_cache.json"))
    autotune.clear_memory_cache()
    yield torch.device("cuda")
    autotune.clear_memory_cache()


def test_one_counter_table_names_every_kernel_counter():
    """``ops.COUNTERS`` lists every counter a kernel module keeps, so
    ``launch_counts`` reads it, ``reset_launch_counts`` zeroes it and a
    captured step replays it: a kernel whose counter is not in the table
    would undercount under capture."""
    import importlib
    import pkgutil
    import repro_torch.kernels as pkg
    kept = set()
    for info in pkgutil.iter_modules(pkg.__path__):
        mod = importlib.import_module(f"{pkg.__name__}.{info.name}")
        kept.update((mod.__name__, name) for name, value in vars(mod).items()
                    if (name.startswith("launches") or name == "calls")
                    and type(value) is int)
    assert kept == {(m.__name__, a) for m, a in ops.COUNTERS.values()}
    assert graphs.CapturedStep(lambda x: x, CPU)._counters == list(
        ops.COUNTERS.values())
    exchange.calls += 1
    csr_aggregate.launches += 1
    ops.reset_launch_counts()
    assert set(ops.launch_counts()) == set(ops.COUNTERS)
    assert not any(ops.launch_counts().values())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["local", "sequential", "sync", "stale"])
def test_cuda_captured_training_equals_eager(cuda, graph, mode):
    """Replayed graphs against the eager loop on the card, dropout 0.3:
    losses, parameters, table and exchanges bitwise, the launches equal."""
    ds, batch, halo = graph
    runs, launches = [], []
    for capture in (True, False):
        ops.reset_launch_counts()
        kw = dict(epochs=4, lr=LR, seed=0, device=cuda,
                  params=_params(ds, cuda), capture=capture)
        if mode == "sync":
            runs.append(train_sync(ds, batch, halo, _cfg(), **kw))
        elif mode == "stale":
            runs.append(train_stale(ds, batch, halo, _cfg(), sync_period=2,
                                    **kw))
        else:
            runs.append(train_local(ds, batch, _cfg(),
                                    sequential=mode == "sequential", **kw))
        torch.cuda.synchronize()
        launches.append(ops.launch_counts())
    cap, eager = runs
    assert np.array_equal(cap.losses, eager.losses)
    assert _equal(cap.params, eager.params)
    assert torch.equal(cap.embeddings, eager.embeddings)
    assert launches[0] == launches[1]
    assert launches[0]["fused_gcn_layer_need_agg"] > 0
    if mode in ("sync", "stale"):
        assert np.array_equal(cap.exchanges, eager.exchanges)
    assert sum(cap.compiles.values()) == (2 if mode == "stale" else 1)
    # the masks moved on: no two epochs' losses are equal
    assert len({tuple(r) for r in cap.losses.tolist()}) == 4


@pytest.mark.cuda
def test_cuda_replays_draw_the_eager_masks(cuda):
    """A captured draw from a caller's generator: each replay draws what
    the eager call draws next, and leaves the generator where it does."""
    def draw(gen):
        return torch.rand(1000, generator=gen, device=cuda) < 0.7
    step = graphs.CapturedStep(draw, cuda)
    g_cap = torch.Generator(device=cuda).manual_seed(5)
    g_eager = torch.Generator(device=cuda).manual_seed(5)
    masks = []
    for _ in range(3):
        got = step(g_cap).clone()
        assert torch.equal(got, draw(g_eager))
        masks.append(got)
    assert not torch.equal(masks[0], masks[1])
    assert torch.equal(g_cap.get_state(), g_eager.get_state())
    assert step.compiles == 1


@pytest.mark.cuda
def test_cuda_capture_failure_raises(cuda):
    """A host read inside the captured region cannot be captured: it
    raises, naming the step, and nothing falls back to eager."""
    step = graphs.CapturedStep(lambda x: x * float(x.sum().item()), cuda,
                               name="host_read")
    with pytest.raises(graphs.CaptureError, match="host_read"):
        step(torch.ones(4, device=cuda))


@pytest.mark.cuda
def test_cuda_served_answers_captured_equal_eager(cuda, graph, tmp_path):
    """The batcher with captured buckets against eager programs on one
    store: every answer's label, logits and source equal, warmup's
    compiles 2 per bucket, none after."""
    from repro_torch.pipeline.pipeline import PipelineConfig, run_inference
    from repro_torch.serving.batcher import ContinuousBatcher
    from repro_torch.serving.replay import make_zipf_workload
    from repro_torch.serving.store import EmbeddingStore
    cfg = PipelineConfig(dataset="arxiv-like", dataset_kwargs={"n": 600},
                         k=K, hidden_dim=16, embed_dim=16,
                         serving_dir=str(tmp_path))
    store = EmbeddingStore.load(run_inference(cfg, device=cuda).serving_path,
                                device=cuda)
    workload = make_zipf_workload(store.n, num_queries=400,
                                  unseen_frac=0.1, max_neighbors=8, seed=0)
    answers = []
    for capture in (True, False):
        batcher = ContinuousBatcher(store, max_batch=16, max_neighbors=8,
                                    now=lambda: 0.0, capture=capture)
        assert batcher.warmup() == 10
        for node, nbs in workload:
            batcher.submit(node, neighbors=nbs)
        answers.append(batcher.drain())
        assert batcher.compiles.steady_state_recompiles == 0
    for a, b in zip(*answers):
        assert (a.label, a.source, a.shard) == (b.label, b.source, b.shard)
        assert np.array_equal(a.logits, b.logits)
        assert np.array_equal(a.embedding, b.embedding)
    known = [a for a in answers[0] if store.is_known(a.node_id)]
    assert [a.label for a in known] == [int(store.predictions[a.node_id])
                                        for a in known]


@pytest.mark.cuda
def test_cuda_decoded_tokens_captured_equal_eager(cuda):
    """Reduced qwen3_4b on the card: 8 decode steps of one prefilled
    bucket, captured and eager from copies of one cache: every token and
    the caches bitwise equal; then ``serve``'s report both ways."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as port_serve
    from repro_torch.models.lm import grow_cache, init_model, prefill_step
    cfg = get_config("qwen3_4b").reduced()
    params = init_model(cfg, cuda, seed=0)
    gen = torch.Generator(device=cuda).manual_seed(0)
    prompt = torch.randint(1, cfg.vocab_size, (3, 16), generator=gen,
                           device=cuda, dtype=torch.int32)
    with torch.no_grad():
        logits, cache, _ = prefill_step(params, cfg, {"tokens": prompt})
        first = logits.argmax(dim=-1).to(torch.int32)[:, None]
        out = []
        for capture in (True, False):
            decode = port_serve.make_decode(params, cfg, cuda, capture)
            grown = grow_cache(cache, 24)
            tok, lengths = first, torch.tensor([10, 16, 12], device=cuda,
                                               dtype=torch.int32)
            toks = []
            for _ in range(8):
                tok, lengths, _ = decode(tok, lengths, grown)
                toks.append(tok.clone())
            out.append((torch.cat(toks, dim=1), grown))
    assert torch.equal(out[0][0], out[1][0])
    for name in ("k", "v"):
        assert torch.equal(out[0][1]["layers"][name],
                           out[1][1]["layers"][name])
    args = argparse.Namespace(arch="qwen3_4b", reduced=True, requests=5,
                              min_prompt=6, max_prompt=40, max_new=8,
                              seed=0, device="cuda")
    cap = port_serve.serve(args)
    eager = port_serve.serve(args, capture=False)
    assert cap["sample_generation"] == eager["sample_generation"]
    assert cap["finite"] and eager["finite"]
    assert cap["decode_compiles"] == len(cap["prefill_buckets"])
