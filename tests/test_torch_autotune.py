"""``repro_torch.kernels.autotune`` against the reference's
``repro.kernels.autotune``, and the configs it resolves on the main path.

* Resolution: the CPU falls back to ``"torch"``, an H100 key with an empty
  cache to ``cuda_fused``/64/0 (today's launches), and an override wins;
  ``shape_bucket`` keys equal the reference's over a grid of shapes.
* ``candidate_space``: ``["torch"]`` on the CPU; on the H100 key (with the
  H100's opt-in shared memory, 232,448 bytes) both CUDA strategies over
  the knob sweep in a fixed order, the fallback first, each within kernel
  B's shared-memory and thread limits, and never ``"torch"``.
* The cache: two processes resolve the same winner (the counterpart of
  ``tests/test_fused_layer.py``'s determinism test), an in-process hit
  returns no measurements and counts ``autotune.cache_hits``, the user
  cache beats the factory table, and malformed entries or strategies this
  package lacks (the reference's ``"xla"``) are skipped.
* Strategy parity: ``gcn_layer``/``sage_layer`` forward and gradients in
  (h, arc weights, W, b) under an override of each port strategy (on the
  CPU, its plain composition) against the reference's layers under
  ``"xla"``, ``"pallas"`` and ``"pallas_fused"`` (interpret mode), at 3e-5
  forward and 3e-4 for the gradients (``tests/test_fused_layer.py``'s).
* The pipeline's ``kernel_autotune`` stage and report against the
  reference's, the CLI flag, and serving's per-bucket config.
* The tuner: a candidate replaces the fallback only when it wins by more
  than the measured spread; it times the caller's own graphs (the
  pipeline's partitions, also in a low-memory run) and sweeps ``items``
  only on them; a repeated resolution is one lookup.
* ``cuda`` tests (skipped here, in a fixture): every candidate against the
  plain version on the card, the row-tile variants bitwise equal, the
  tuner on the device's clock, and a CUDA tensor under ``"torch"``
  raising.

Every file the tests write is under ``tmp_path``; the cache paths are set
with ``monkeypatch.setenv`` or a subprocess's ``env=``.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings                          # noqa: E402
from hypothesis import strategies as st                         # noqa: E402

from repro_torch import obs                                     # noqa: E402
from repro_torch.gnn import layers                              # noqa: E402
from repro_torch.kernels import autotune as at                  # noqa: E402
from repro_torch.kernels import ops                             # noqa: E402
from repro_torch.kernels import ref as plain                    # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "cuda/NVIDIA H100 80GB HBM3"
H100_SMEM = 232448
MAIN_BUCKET = at.ShapeBucket(131072, 524288, 128)
FWD_TOL = dict(rtol=3e-5, atol=3e-5)
GRAD_TOL = dict(rtol=3e-4, atol=3e-4)


def _child_env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep \
        + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """A fresh memo, an empty user cache under tmp_path, no exhaustive
    sweep, and a clean obs registry for every test."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune_cache.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE",
                       str(tmp_path / "ref_autotune_cache.json"))
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_EXHAUSTIVE", raising=False)
    monkeypatch.delenv("REPRO_AUTOTUNE_EXHAUSTIVE", raising=False)
    at.clear_memory_cache()
    obs.reset()
    yield
    at.clear_memory_cache()
    obs.reset()


@pytest.fixture
def ref_at():
    """The reference's autotuner (JAX; the machine with the card runs only
    the ``cuda`` tests and may have no JAX)."""
    pytest.importorskip("jax")
    ref_autotune = _ref_autotune()
    ref_autotune.clear_memory_cache()
    yield ref_autotune
    ref_autotune.clear_memory_cache()


def _ref_autotune():
    """The reference's autotune module (``repro.kernels`` exports a
    function of the same name, which an attribute import would give)."""
    import importlib
    return importlib.import_module("repro.kernels.autotune")


def _write_cache(path, configs):
    with open(path, "w") as f:
        json.dump({"version": 1, "configs": configs}, f)


# ---------------------------------------------------------------------------
# resolution: fallback, override, buckets
# ---------------------------------------------------------------------------
def test_cpu_falls_back_to_the_plain_versions():
    assert at.get_config(600, 1500, 40, "cpu") == at.KernelConfig("torch")
    assert at.get_config(600, 1500, 40, torch.device("cpu")).strategy \
        == "torch"
    assert at.backend_key("cpu") == at.backend_key(torch.device("cpu")) \
        == "cpu"


def test_h100_key_with_an_empty_cache_falls_back_to_todays_launches():
    cfg = at.get_config(79344, 325288, 128, H100)
    assert cfg == at.FALLBACK == at.KernelConfig("cuda_fused", 64, 0)
    assert cfg.as_dict() == {"strategy": "cuda_fused", "node_tile": 64,
                             "items": 0}
    assert at.KernelConfig.from_dict(cfg.as_dict()) == cfg


def test_override_wins_over_cache_and_fallback(tmp_path):
    bucket = at.shape_bucket(600, 1500, 40)
    _write_cache(tmp_path / "autotune_cache.json",
                 {"cpu": {bucket.key: {"config": {"strategy": "cuda",
                                                  "items": 32}}}})
    assert at.get_config(600, 1500, 40, "cpu") == at.KernelConfig(
        "cuda", items=32)
    forced = at.KernelConfig("cuda_fused", node_tile=128, items=16)
    with at.override(forced):
        assert at.get_config(600, 1500, 40, "cpu") == forced
        assert at.get_config(8, 8, 8, H100) == forced
    assert at.get_config(600, 1500, 40, "cpu").strategy == "cuda"


@pytest.mark.parametrize("bad", [dict(strategy="xla"),
                                 dict(strategy="pallas_fused"),
                                 dict(node_tile=512), dict(items=8),
                                 dict(items=256)])
def test_kernel_config_rejects_what_the_kernels_lack(bad):
    with pytest.raises(ValueError):
        at.KernelConfig(**bad)


@settings(max_examples=60, database=None, derandomize=True, deadline=None)
@given(n=st.integers(1, 1 << 21), e=st.integers(0, 1 << 23),
       f=st.integers(1, 2048))
def test_shape_bucket_keys_equal_the_reference(n, e, f):
    pytest.importorskip("jax")
    from repro.kernels.autotune import shape_bucket as ref_bucket
    assert at.shape_bucket(n, e, f).key == ref_bucket(n, e, f).key


# ---------------------------------------------------------------------------
# the candidate space
# ---------------------------------------------------------------------------
def test_candidate_space_cpu_is_the_plain_versions(monkeypatch):
    assert at.candidate_space(MAIN_BUCKET, "cpu") == [at.KernelConfig(
        "torch")]
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_EXHAUSTIVE", "1")
    assert [c.strategy for c in at.candidate_space(MAIN_BUCKET, "cpu")] \
        == ["torch", "cuda_fused", "cuda"]


def test_candidate_space_h100_sweeps_both_cuda_strategies():
    cands = at.candidate_space(MAIN_BUCKET, H100, smem_limit=H100_SMEM)
    assert cands and cands == at.candidate_space(MAIN_BUCKET, H100,
                                                 smem_limit=H100_SMEM)
    assert cands[0] == at.FALLBACK and len(set(cands)) == len(cands)
    assert {c.strategy for c in cands} == {"cuda_fused", "cuda"}
    for c in cands:
        assert at.smem_bytes(c.node_tile) <= H100_SMEM
        assert at.block_threads(c.node_tile) <= 1024
        assert c.items == 0 or c.items <= MAIN_BUCKET.n + MAIN_BUCKET.e
    assert {c.node_tile for c in cands if c.strategy == "cuda_fused"} \
        == set(at.NODE_TILES)
    assert {c.items for c in cands} == {0, *at.ITEMS}
    assert 16 <= len(cands) <= 20


def test_candidate_space_filters_shared_memory_and_items():
    # 48 KB: kernel B's 64- and 128-row tiles need 50 and 68 KB
    cands = at.candidate_space(MAIN_BUCKET, H100, smem_limit=48 * 1024)
    assert {c.node_tile for c in cands if c.strategy == "cuda_fused"} \
        == {32}
    assert at.smem_bytes(32) == 41984 and at.smem_bytes(64) == 51200
    tiny = at.ShapeBucket(8, 24, 128)       # n + e = 32 merged items
    assert {c.items for c in at.candidate_space(tiny, H100,
                                                smem_limit=H100_SMEM)} \
        == {0, 16, 32}


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------
_TUNE_SNIPPET = """
import json
from repro_torch import obs
from repro_torch.kernels.autotune import autotune, get_config
cfg, measured = autotune(600, 1500, 40, "cpu", repeats=1)
print(json.dumps({"config": cfg.as_dict(), "measured": sorted(measured),
                  "resolved": get_config(600, 1500, 40, "cpu").as_dict(),
                  "hits": obs.counter("autotune.cache_hits").value}))
"""


def test_autotune_cache_is_deterministic_across_processes(tmp_path):
    """Two fresh processes sharing REPRO_TORCH_AUTOTUNE_CACHE resolve the
    same config; the first measures the exhaustive CPU sweep, the second
    is a pure cache hit."""
    cache = tmp_path / "shared.json"
    outs = []
    for _ in range(2):
        r = subprocess.run(
            [sys.executable, "-c", _TUNE_SNIPPET], capture_output=True,
            text=True, timeout=300, cwd=ROOT,
            env=_child_env(REPRO_TORCH_AUTOTUNE_CACHE=str(cache),
                           REPRO_TORCH_AUTOTUNE_EXHAUSTIVE="1"))
        assert r.returncode == 0, r.stderr
        outs.append(json.loads(r.stdout.strip().splitlines()[-1]))
    assert outs[0]["config"] == outs[1]["config"] == outs[0]["resolved"] \
        == outs[1]["resolved"]
    assert outs[0]["measured"] == sorted(
        ["torch/nt64/it0", "cuda_fused/nt64/it0", "cuda/nt64/it0"])
    assert outs[0]["hits"] == 0
    assert outs[1]["measured"] == [] and outs[1]["hits"] == 1
    data = json.loads(cache.read_text())
    (key,) = data["configs"]["cpu"].keys()
    assert key == at.shape_bucket(600, 1500, 40).key
    assert data["configs"]["cpu"][key]["source"] == "tuned"
    assert not list(tmp_path.glob("*.tmp"))     # the rewrite is atomic


def test_autotune_in_process_hit_returns_no_measurements(tmp_path):
    cfg1, measured1 = at.autotune(100, 700, 24, "cpu")
    cfg2, measured2 = at.autotune(100, 700, 24, "cpu")
    assert cfg1 == cfg2 == at.KernelConfig("torch")
    assert measured1 == {} == measured2       # one candidate: nothing timed
    assert obs.counter("autotune.cache_hits").value == 1
    assert obs.counter("autotune.candidates_measured").value == 0
    assert (tmp_path / "autotune_cache.json").exists()


def test_autotune_measures_every_candidate_and_keeps_the_argmin(
        monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_EXHAUSTIVE", "1")
    obs.enable()
    cfg, measured = at.autotune(300, 900, 16, "cpu", repeats=1)
    cands = at.candidate_space(at.shape_bucket(300, 900, 16), "cpu")
    assert list(measured) == [at.cand_key(c) for c in cands]
    assert all(ms > 0 for ms in measured.values())
    best = min(measured.values())
    assert cfg == next(c for c in cands if measured[at.cand_key(c)] == best)
    assert obs.counter("autotune.candidates_measured").value == len(cands)
    names = [s.name for s in obs.tracer().spans()]
    assert names.count("autotune.bucket") == 1
    assert names.count("autotune.candidate") == len(cands)
    assert at.get_config(300, 900, 16, "cpu") == cfg


def _scripted(monkeypatch, samples):
    """The probe's timer replaced by scripted ms samples per candidate."""
    monkeypatch.setattr(at, "_measure", lambda cfg, probe, repeats, device:
                        samples[at.cand_key(cfg)])


@pytest.mark.parametrize("samples, winner", [
    # below the fallback's median by less than its spread: no win
    ({"cuda_fused/nt64/it0": [9.0, 9.6, 9.7],
      "cuda/nt64/it0": [9.8, 9.9, 10.0]}, "torch/nt64/it0"),
    # below it by more than either spread: a win
    ({"cuda_fused/nt64/it0": [8.0, 8.1, 8.2],
      "cuda/nt64/it0": [9.8, 9.9, 10.0]}, "cuda_fused/nt64/it0"),
    # of two clear wins, the faster
    ({"cuda_fused/nt64/it0": [8.0, 8.1, 8.2],
      "cuda/nt64/it0": [7.0, 7.1, 7.2]}, "cuda/nt64/it0"),
    # the candidate's own spread counts too
    ({"cuda_fused/nt64/it0": [6.0, 8.0, 9.9],
      "cuda/nt64/it0": [9.8, 9.9, 10.0]}, "torch/nt64/it0"),
])
def test_autotune_keeps_the_fallback_unless_a_win_clears_the_spread(
        tmp_path, monkeypatch, samples, winner):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_EXHAUSTIVE", "1")
    samples = {"torch/nt64/it0": [10.0, 10.5, 11.0], **samples}
    _scripted(monkeypatch, samples)
    cfg, measured = at.autotune(300, 900, 16, "cpu")
    assert at.cand_key(cfg) == winner
    assert measured == {k: v[1] for k, v in samples.items()}
    entry = json.loads((tmp_path / "autotune_cache.json").read_text())[
        "configs"]["cpu"][at.shape_bucket(300, 900, 16).key]
    assert entry["config"] == cfg.as_dict()
    assert entry["spread_ms"] == {k: round(max(v) - min(v), 4)
                                  for k, v in samples.items()}
    assert entry["probe"] == "uniform"
    assert at.get_config(300, 900, 16, "cpu") == cfg


def _cpu_graph(seed, n=300, e=900):
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, n, e))
    t = lambda x, dt: torch.as_tensor(x, dtype=dt)              # noqa: E731
    csr = ops.to_csr(t(rng.integers(0, n, e), torch.int32),
                     t(dst, torch.int32), t(rng.random(e), torch.float32), n)
    return csr, t(np.bincount(dst, minlength=n), torch.float32)


def test_autotune_times_the_callers_own_graphs(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_EXHAUSTIVE", "1")
    graphs = [_cpu_graph(0), _cpu_graph(1)]
    probes = []
    real = at._measure

    def spy(cfg, probe, repeats, device):
        probes.append(probe)
        return real(cfg, probe, repeats, device)
    monkeypatch.setattr(at, "_measure", spy)
    cfg, measured = at.autotune(300, 900, 16, "cpu", repeats=2,
                                graphs=iter(graphs))
    assert len(probes) == len(measured) == 3
    h, w, b, pairs = probes[0]
    assert h.shape == (300, 16) and w.shape == (16, 16) and b.shape == (16,)
    assert [csr for csr, _ in pairs] == [csr for csr, _ in graphs]
    for (_, inv), (_, deg) in zip(pairs, graphs):
        assert torch.equal(inv, ops.inv_degree(deg))
    entry = json.loads((tmp_path / "autotune_cache.json").read_text())[
        "configs"]["cpu"][at.shape_bucket(300, 900, 16).key]
    assert entry["probe"] == "own graphs"
    assert set(entry["spread_ms"]) == set(measured)
    with pytest.raises(ValueError, match="bucket"):
        at.autotune(300, 900, 16, "cpu", force=True,
                    graphs=[_cpu_graph(0, n=2000)])


def test_autotune_reads_no_graph_for_one_candidate():
    def unread():
        raise AssertionError("a graph was read")
        yield                                            # noqa: unreachable
    cfg, measured = at.autotune(300, 900, 16, "cpu", graphs=unread())
    assert cfg == at.KernelConfig("torch") and measured == {}


def test_candidate_space_without_own_graphs_keeps_the_rules_split():
    cands = at.candidate_space(MAIN_BUCKET, H100, smem_limit=H100_SMEM,
                               sweep_items=False)
    full = at.candidate_space(MAIN_BUCKET, H100, smem_limit=H100_SMEM)
    assert cands[0] == at.FALLBACK and {c.items for c in cands} == {0}
    assert [c for c in full if c.items == 0] == cands
    assert {c.node_tile for c in cands if c.strategy == "cuda_fused"} \
        == set(at.NODE_TILES)
    assert [c.strategy for c in cands].count("cuda") == 1


def test_repeated_resolution_is_one_lookup(tmp_path, monkeypatch):
    key = at.shape_bucket(600, 1500, 40).key
    tuned = at.KernelConfig("cuda", items=32)
    _write_cache(tmp_path / "autotune_cache.json",
                 {"cpu": {key: {"config": tuned.as_dict()}}})
    assert at.get_config(600, 1500, 40, "cpu") == tuned

    def unreachable(*args, **kwargs):
        raise AssertionError("a repeated resolution did more than a lookup")
    with monkeypatch.context() as m:
        for name in ("_read_json", "cache_path", "shape_bucket",
                     "backend_key", "_seed_memo"):
            m.setattr(at, name, unreachable)
        for _ in range(3):
            assert at.get_config(600, 1500, 40, "cpu") == tuned
    # another cache path is read at the next clear_memory_cache()
    other = tmp_path / "other.json"
    _write_cache(other, {"cpu": {key: {"config": {"strategy": "cuda_fused",
                                                  "node_tile": 32}}}})
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(other))
    assert at.get_config(600, 1500, 40, "cpu") == tuned
    at.clear_memory_cache()
    assert at.get_config(600, 1500, 40, "cpu") == at.KernelConfig(
        "cuda_fused", 32, 0)
    # a bucket resolved to the fallback takes a later tuned entry at once
    assert at.get_config(300, 900, 16, "cpu") == at.KernelConfig("torch")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_EXHAUSTIVE", "1")
    _scripted(monkeypatch, {"torch/nt64/it0": [2.0], "cuda/nt64/it0": [1.0],
                            "cuda_fused/nt64/it0": [3.0]})
    at.autotune(300, 900, 16, "cpu")
    assert at.get_config(300, 900, 16, "cpu") == at.KernelConfig("cuda")


def test_user_cache_beats_the_factory_table(tmp_path, monkeypatch):
    factory = tmp_path / "factory.json"
    a, b = at.shape_bucket(600, 1500, 40), at.shape_bucket(10, 10, 10)
    _write_cache(factory, {H100: {
        a.key: {"config": {"strategy": "cuda", "items": 64}},
        b.key: {"config": {"strategy": "cuda_fused", "node_tile": 32}}}})
    _write_cache(tmp_path / "autotune_cache.json", {H100: {
        a.key: {"config": {"strategy": "cuda_fused", "node_tile": 128,
                           "items": 16}}}})
    monkeypatch.setattr(at, "_DEFAULTS_PATH", str(factory))
    at.clear_memory_cache()
    assert at.get_config(600, 1500, 40, H100) == at.KernelConfig(
        "cuda_fused", 128, 16)
    assert at.get_config(10, 10, 10, H100) == at.KernelConfig(
        "cuda_fused", 32, 0)
    assert at.get_config(10, 10, 10, "cpu") == at.KernelConfig("torch")


def test_shipped_factory_table_is_empty_and_readable():
    with open(at._DEFAULTS_PATH) as f:
        data = json.load(f)
    assert data["version"] == 1 and data["configs"] == {}


def test_unreadable_and_foreign_entries_are_skipped(tmp_path):
    keys = [at.shape_bucket(n, 4 * n, 128).key for n in (64, 128, 256,
                                                          512, 1024)]
    _write_cache(tmp_path / "autotune_cache.json", {
        H100: {keys[0]: {"config": {"strategy": "xla"}},      # reference's
               keys[1]: "not an entry",
               keys[2]: {"config": {"strategy": "cuda", "node_tile": 512}},
               keys[3]: {"no config": 1},
               keys[4]: {"config": {"strategy": "cuda", "items": 32}}},
        "cpu": ["not", "a", "table"]})
    for n in (64, 128, 256, 512):
        assert at.get_config(n, 4 * n, 128, H100) == at.FALLBACK
    assert at.get_config(1024, 4096, 128, H100) == at.KernelConfig(
        "cuda", items=32)
    assert at.get_config(64, 256, 128, "cpu") == at.KernelConfig("torch")
    (tmp_path / "autotune_cache.json").write_text("{ not json")
    at.clear_memory_cache()
    assert at.get_config(1024, 4096, 128, H100) == at.FALLBACK
    # a tuned entry lands beside the unreadable file's content
    at.autotune(1024, 4096, 128, "cpu")
    data = json.loads((tmp_path / "autotune_cache.json").read_text())
    assert list(data["configs"]["cpu"]) == [at.shape_bucket(
        1024, 4096, 128).key]


def test_the_reference_cache_is_not_read(tmp_path, ref_at):
    key = at.shape_bucket(600, 1500, 40).key
    _write_cache(tmp_path / "ref_autotune_cache.json",
                 {"cpu": {key: {"config": {"strategy": "pallas"}}}})
    assert ref_at.get_config(600, 1500, 40).strategy == "pallas"
    assert at.get_config(600, 1500, 40, "cpu") == at.KernelConfig("torch")


# ---------------------------------------------------------------------------
# strategy parity against the reference's layers
# ---------------------------------------------------------------------------
SHAPES = {"tiny": (8, 16, 32, 16), "ragged": (100, 24, 700, 50)}
_REF_RESULTS = {}


def _layer_inputs(shape, kind):
    """Seeded graph with duplicate destinations and zero-degree rows (dst
    in the first half of the rows), features and layer parameters."""
    n, f, e, fo = SHAPES[shape]
    rng = np.random.default_rng(n + fo)
    h = rng.normal(size=(n, f)).astype(np.float32)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = np.sort(rng.integers(0, max(n // 2, 1), e)).astype(np.int32)
    w_edge = rng.random(e).astype(np.float32)
    deg = np.bincount(dst, minlength=n)[:n].astype(np.float32)
    params = {"b": (rng.normal(size=(fo,)) * 0.1).astype(np.float32)}
    for name in (("w",) if kind == "gcn" else ("w_self", "w_neigh")):
        params[name] = (rng.normal(size=(f, fo)) * 0.3).astype(np.float32)
    return h, src, dst, w_edge, deg, params


def _reference(kind, shape, strategy):
    """value, out and gradients (h, arc weights, params) of
    ``sum(layer(...)²)`` through the reference's layer under ``strategy``;
    computed once per case (interpret mode is slow)."""
    key = (kind, shape, strategy)
    if key not in _REF_RESULTS:
        import jax
        import jax.numpy as jnp
        from repro.gnn import layers as ref_layers
        ref_autotune = _ref_autotune()
        h, src, dst, w_edge, deg, params = _layer_inputs(shape, kind)
        fn = ref_layers.gcn_layer if kind == "gcn" else ref_layers.sage_layer

        def loss(h, w_edge, params):
            out = fn(params, h, jnp.asarray(src), jnp.asarray(dst), w_edge,
                     jnp.asarray(deg), activate=True, use_kernel=True)
            return jnp.sum(out * out), out

        with ref_autotune.override(ref_autotune.KernelConfig(
                strategy=strategy)):
            (val, out), grads = jax.value_and_grad(
                loss, argnums=(0, 1, 2), has_aux=True)(
                jnp.asarray(h), jnp.asarray(w_edge),
                {k: jnp.asarray(v) for k, v in params.items()})
        _REF_RESULTS[key] = (float(val), np.asarray(out),
                             jax.tree.map(np.asarray, grads))
    return _REF_RESULTS[key]


@pytest.mark.parametrize("kind", ["gcn", "sage"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("strategy", at.STRATEGIES)
@pytest.mark.parametrize("ref_strategy", ["xla", "pallas", "pallas_fused"])
def test_layer_strategy_parity_with_the_reference(kind, shape, strategy,
                                                  ref_strategy):
    pytest.importorskip("jax")
    val_r, out_r, (dh_r, dw_edge_r, dparams_r) = _reference(kind, shape,
                                                            ref_strategy)
    h, src, dst, w_edge, deg, params = _layer_inputs(shape, kind)
    h_t = torch.as_tensor(h).requires_grad_()
    w_t = torch.as_tensor(w_edge).requires_grad_()
    p_t = {k: torch.as_tensor(v).requires_grad_() for k, v in params.items()}
    csr = ops.to_csr(torch.as_tensor(src), torch.as_tensor(dst), w_t,
                     h.shape[0])
    fn = layers.gcn_layer if kind == "gcn" else layers.sage_layer
    ops.reset_launch_counts()
    with at.override(at.KernelConfig(strategy)):
        out = fn(p_t, h_t, csr, torch.as_tensor(deg), activate=True)
        (out * out).sum().backward()
    assert ops.launch_counts()["fused_gcn_layer"] == 0    # no card here
    np.testing.assert_allclose(out.detach().numpy(), out_r, **FWD_TOL)
    np.testing.assert_allclose(float((out * out).sum().detach()), val_r,
                               rtol=1e-4)
    np.testing.assert_allclose(h_t.grad.numpy(), dh_r, err_msg="dh",
                               **GRAD_TOL)
    np.testing.assert_allclose(w_t.grad.numpy(), dw_edge_r,
                               err_msg="dw_edge", **GRAD_TOL)
    for name, g in dparams_r.items():
        np.testing.assert_allclose(p_t[name].grad.numpy(), g, err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("strategy", at.STRATEGIES)
def test_aggregate_mean_is_the_plain_version_under_every_strategy(strategy):
    h, src, dst, w_edge, deg, _ = _layer_inputs("ragged", "gcn")
    csr = ops.to_csr(torch.as_tensor(src), torch.as_tensor(dst),
                     torch.as_tensor(w_edge), h.shape[0])
    with at.override(at.KernelConfig(strategy, items=16)):
        out = layers.aggregate_mean(torch.as_tensor(h), csr,
                                    torch.as_tensor(deg))
    expect = plain.csr_aggregate_ref(
        torch.as_tensor(h), csr.src, csr.dst, csr.weight, h.shape[0],
        ops.inv_degree(torch.as_tensor(deg)))
    assert torch.equal(out, expect)


def test_untuned_cpu_layer_is_bitwise_the_torch_strategy():
    """The CPU's fallback is the path the port always took there: the
    layer under no override equals it under ``"torch"`` bit for bit."""
    h, src, dst, w_edge, deg, params = _layer_inputs("ragged", "gcn")
    csr = ops.to_csr(torch.as_tensor(src), torch.as_tensor(dst),
                     torch.as_tensor(w_edge), h.shape[0])

    def run():
        h_t = torch.as_tensor(h).requires_grad_()
        p_t = {k: torch.as_tensor(v).requires_grad_()
               for k, v in params.items()}
        out = layers.gcn_layer(p_t, h_t, csr, torch.as_tensor(deg))
        (out * out).sum().backward()
        return out.detach(), h_t.grad, p_t["w"].grad
    untuned = run()
    with at.override(at.KernelConfig("torch")):
        forced = run()
    assert all(torch.equal(a, b) for a, b in zip(untuned, forced))


# ---------------------------------------------------------------------------
# the pipeline, its CLI, and serving
# ---------------------------------------------------------------------------
DIMS = dict(k=2, epochs=2, classifier_epochs=3, hidden_dim=16, embed_dim=16,
            num_layers=2, classifier_hidden=32)


def test_pipeline_kernel_autotune_matches_the_reference(ref_at):
    from repro import obs as ref_obs
    from repro.pipeline import Pipeline
    from repro.pipeline import PipelineConfig as RefConfig
    from repro_torch.pipeline.pipeline import (PipelineConfig,
                                               PipelineReport, run_training)

    untuned = run_training(PipelineConfig(dataset="karate", **DIMS),
                           device="cpu")
    obs.reset()
    obs.enable()
    cfg = PipelineConfig(dataset="karate", kernel_autotune=True, **DIMS)
    tuned = run_training(cfg, device="cpu")
    report = PipelineReport.of(cfg, tuned)
    port_spans = {s.name for s in obs.tracer().spans()}
    port_counters = {n: obs.counter(n).value for n in (
        "autotune.cache_hits", "autotune.candidates_measured")}
    obs.reset()

    ref_obs.reset()
    try:
        ref_obs.enable()
        ref_report = Pipeline(RefConfig(
            dataset="karate", cache_dir=None, collect_hlo=False,
            shard_data_axis=False, use_kernel=True, kernel_autotune=True,
            **DIMS)).run()
        ref_spans = {s.name for s in ref_obs.tracer().spans()}
        ref_counters = {n: ref_obs.counter(n).value
                        for n in port_counters}
    finally:
        ref_obs.reset()

    assert "kernel_autotune" in tuned.timings
    assert "kernel_autotune" not in untuned.timings
    assert set(report.kernel) == set(ref_report.kernel)
    assert {v["strategy"] for v in report.kernel.values()} == {"torch"}
    assert {v["strategy"] for v in ref_report.kernel.values()} == {"xla"}
    assert "aggregation=kernel[torch]" in report.summary()
    assert "aggregation=kernel[xla]" in ref_report.summary()
    assert torch.equal(tuned.embeddings, untuned.embeddings)
    np.testing.assert_array_equal(tuned.losses, untuned.losses)
    assert {"pipeline.kernel_autotune", "autotune.bucket"} <= port_spans
    assert {"pipeline.kernel_autotune", "autotune.bucket"} <= ref_spans
    assert port_counters == ref_counters


@pytest.mark.parametrize("low_memory", [False, True])
def test_pipeline_tunes_on_its_own_partitions(tmp_path, monkeypatch,
                                              low_memory):
    from repro_torch.pipeline.pipeline import PipelineConfig, run_training
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_EXHAUSTIVE", "1")
    probes = []
    real = at._measure

    def spy(cfg, probe, repeats, device):
        probes.append(probe)
        return real(cfg, probe, repeats, device)
    monkeypatch.setattr(at, "_measure", spy)
    cfg = PipelineConfig(dataset="karate", kernel_autotune=True,
                         low_memory=low_memory, **DIMS)
    result = run_training(cfg, device="cpu")
    batch = result.batch
    widths = sorted({result.gnn.feature_dim, result.gnn.hidden_dim})
    buckets = {at.shape_bucket(batch.n_pad, batch.e_pad, w).key
               for w in widths}
    assert len(probes) == 3 * len(buckets)      # a width's bucket is tuned
                                                # once, then a cache hit
    for h, _, _, pairs in probes:
        assert h.shape[0] == batch.n_pad and len(pairs) == batch.k
        for p, (csr, inv) in enumerate(pairs):
            own = ops.to_csr(*(torch.as_tensor(x[p]) for x in (
                batch.edge_src, batch.edge_dst, batch.edge_weight)),
                batch.n_pad)
            assert torch.equal(csr.row_ptr, own.row_ptr)
            assert torch.equal(csr.src, own.src.int())
            assert torch.equal(inv, ops.inv_degree(
                torch.as_tensor(batch.in_degree[p]).float()))
    entries = json.loads((tmp_path / "autotune_cache.json").read_text())[
        "configs"]["cpu"]
    assert set(entries) == buckets
    assert {e["probe"] for e in entries.values()} == {"own graphs"}


def test_report_names_the_resolved_configs_on_every_run(tmp_path):
    from repro_torch.pipeline.pipeline import (PipelineConfig,
                                               PipelineReport, run_inference)
    cfg = PipelineConfig(dataset="karate", **DIMS)
    result = run_inference(cfg, device="cpu")
    report = PipelineReport.of(cfg, result)
    widths = sorted({result.gnn.feature_dim, result.gnn.hidden_dim})
    assert report.kernel == {f"f{w}": {"strategy": "torch", "node_tile": 64,
                                       "items": 0} for w in widths}
    assert report.as_dict()["kernel"] == report.kernel
    assert not (tmp_path / "autotune_cache.json").exists()


def test_cli_kernel_autotune_writes_the_cache(tmp_path):
    cache = tmp_path / "cli_cache.json"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.pipeline", "run", "--device",
         "cpu", "--dataset", "karate", "--k", "2", "--epochs", "1",
         "--classifier-epochs", "2", "--hidden-dim", "16", "--embed-dim",
         "16", "--num-layers", "2", "--kernel-autotune"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=_child_env(REPRO_TORCH_AUTOTUNE_CACHE=str(cache)))
    assert out.returncode == 0, out.stderr
    assert "aggregation=kernel[torch]" in out.stdout
    assert "kernel autotune f=" in out.stderr
    entries = json.loads(cache.read_text())["configs"]["cpu"]
    assert entries and all(e["config"]["strategy"] == "torch"
                           for e in entries.values())


class _Store:
    embed_dim = 16
    partition_of = np.zeros(8, np.int64)
    device = torch.device("cpu")


def test_inductive_engine_resolves_a_config_per_bucket(tmp_path):
    from repro_torch.serving.inductive import InductiveEngine
    eng = InductiveEngine(_Store(), max_neighbors=4)
    assert eng.kernel_config(8) == at.get_config(8 * 5, 8 * 4, 16, "cpu")
    assert eng.kernel_config(8) == at.KernelConfig("torch")
    # a tuned entry for one star graph's bucket reaches that bucket only
    _write_cache(tmp_path / "autotune_cache.json", {"cpu": {
        at.shape_bucket(8 * 5, 8 * 4, 16).key: {
            "config": {"strategy": "cuda", "items": 16}}}})
    at.clear_memory_cache()
    assert eng.kernel_config(8) == at.KernelConfig("cuda", items=16)
    assert eng.kernel_config(64) == at.KernelConfig("torch")


def test_inductive_config_reaches_the_aggregation(monkeypatch):
    from repro_torch.serving import inductive
    seen = []
    real = ops.csr_aggregate

    def spy(h, csr, inv_scale=None, config=None):
        seen.append(config)
        return real(h, csr, inv_scale, config)
    monkeypatch.setattr(inductive.ops, "csr_aggregate", spy)
    rng = np.random.default_rng(0)
    nb = torch.as_tensor(rng.normal(size=(2, 4, 16)), dtype=torch.float32)
    mask = torch.ones(2, 4)
    head_w, head_b = torch.zeros(2, 16, 3), torch.zeros(2, 3)
    forced = at.KernelConfig("cuda", items=32)
    agg, _ = inductive.aggregate_and_head(nb, mask, head_w, head_b,
                                          config=forced)
    agg0, _ = inductive.aggregate_and_head(nb, mask, head_w, head_b)
    assert seen == [forced, None]
    assert torch.equal(agg, agg0)
    torch.testing.assert_close(agg, nb.mean(dim=1))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _skewed_graph(dev, n=3000, f=128, e=20000, pad=6000, seed=5):
    """Random arcs, a hub row of 4,000 live arcs, and weight-0 padding arcs
    parked at row n-1 from source 0, as the assembly parks them."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(0, n, e), rng.integers(0, n, 4000),
                          np.zeros(pad, np.int64)])
    dst = np.concatenate([rng.integers(0, n - 1, e), np.full(4000, 11),
                          np.full(pad, n - 1)])
    w = np.concatenate([rng.random(e + 4000), np.zeros(pad)])
    order = np.argsort(dst, kind="stable")
    src, dst, w = src[order], dst[order], w[order]
    deg = np.bincount(dst, weights=w > 0, minlength=n)
    t = lambda x, dt: torch.as_tensor(x, dtype=dt, device=dev)  # noqa: E731
    csr = ops.to_csr(t(src, torch.int32), t(dst, torch.int32),
                     t(w, torch.float32), n)
    h = t(rng.normal(size=(n, f)), torch.float32)
    wm = t(rng.normal(size=(f, f)) * 0.1, torch.float32)
    b = t(rng.normal(size=f) * 0.1, torch.float32)
    return h, csr, ops.inv_degree(t(deg, torch.float32)), wm, b


def _fwd_bwd(cfg, h, csr, inv, wm, b, g):
    leaves = [x.detach().clone().requires_grad_() for x in (h, wm, b)]
    out = ops.fused_gcn_layer(leaves[0], csr, inv, leaves[1], leaves[2],
                              activate=False, config=cfg)
    grads = torch.autograd.grad((out * g).sum(), leaves)
    return [out.detach(), *grads]


@pytest.mark.cuda
def test_cuda_every_candidate_matches_the_plain_version(cuda):
    h, csr, inv, wm, b = _skewed_graph(cuda)
    g = torch.randn(h.shape, generator=torch.Generator(device=cuda)
                    .manual_seed(1), device=cuda)
    bucket = at.shape_bucket(h.shape[0], csr.src.shape[0], h.shape[1])
    cands = at.candidate_space(bucket, at.backend_key(cuda))
    assert cands[0] == at.FALLBACK and len(cands) >= 16

    def plain_fn(hh, ww, bb):
        return plain.fused_gcn_reference(hh, csr.src, csr.dst, csr.weight,
                                         inv, ww, bb, activate=False)

    def plain_run(xs, c):
        leaves = [x.detach().clone().requires_grad_() for x in xs]
        out = plain_fn(*leaves)
        return [out.detach(), *torch.autograd.grad((out * c).sum(), leaves)]
    expect = plain_run((h, wm, b), g)
    scale = plain_run((h.abs(), wm.abs(), b.abs()), g.abs())
    by_tile = {}
    for cfg in cands:
        got = _fwd_bwd(cfg, h, csr, inv, wm, b, g)
        for name, a, r, s in zip(("out", "dh", "dW", "db"), got, expect,
                                 scale):
            bad = (a - r).abs() > FWD_TOL["atol"] + FWD_TOL["rtol"] * s
            assert not bad.any(), (cfg, name, float((a - r).abs().max()))
        if cfg.strategy == "cuda_fused":
            by_tile.setdefault(cfg.items, []).append(got)
    for items, runs in by_tile.items():
        for other in runs[1:]:
            assert all(torch.equal(x, y) for x, y in zip(runs[0], other)), \
                items


@pytest.mark.cuda
def test_cuda_strategies_launch_their_kernels(cuda):
    h, csr, inv, wm, b = _skewed_graph(cuda)
    g = torch.ones_like(h)
    for cfg, fused in ((at.KernelConfig("cuda_fused", 128, 16), 1),
                       (at.KernelConfig("cuda", items=64), 0)):
        ops.reset_launch_counts()
        _fwd_bwd(cfg, h, csr, inv, wm, b, g)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert counts["fused_gcn_layer"] == fused
        assert counts["csr_aggregate"] == 2 - fused    # + the dh transpose


@pytest.mark.cuda
def test_cuda_autotune_on_own_graphs_times_the_device(cuda, tmp_path):
    """On the card the tuner times a skewed graph of the caller's on the
    device's clock: every candidate is measured, the spreads are written
    beside the medians, and the winner is the fallback or clears the
    margin; a launched-ahead step is timed below its host wall."""
    h, csr, inv, wm, b = _skewed_graph(cuda)
    n, e, f = h.shape[0], csr.src.shape[0], h.shape[1]
    deg = 1.0 / inv                     # inv_degree(deg) gives inv back
    backend = at.backend_key(cuda)
    cfg, measured = at.autotune(n, e, f, backend, repeats=5,
                                graphs=[(csr, deg)])
    cands = at.candidate_space(at.shape_bucket(n, e, f), backend)
    assert list(measured) == [at.cand_key(c) for c in cands]
    assert {c.items for c in cands} == {0, *at.ITEMS}
    entry = json.loads((tmp_path / "autotune_cache.json").read_text())[
        "configs"][backend][at.shape_bucket(n, e, f).key]
    assert entry["probe"] == "own graphs" and entry["config"] == \
        cfg.as_dict()
    spread = entry["spread_ms"]
    base = at.cand_key(at.FALLBACK)
    if cfg != at.FALLBACK:
        key = at.cand_key(cfg)
        assert measured[key] < measured[base] - max(spread[base],
                                                    spread[key])
    probe = at._probe(at.shape_bucket(n, e, f), f, cuda, [(csr, deg)])
    t0 = time.perf_counter()
    device_ms = at._measure(at.FALLBACK, probe, 5, cuda)
    wall_ms = (time.perf_counter() - t0) * 1e3
    assert len(device_ms) == 5 and 0 < max(device_ms) < wall_ms


@pytest.mark.cuda
def test_cuda_tensor_under_the_torch_strategy_raises(cuda):
    h, csr, inv, wm, b = _skewed_graph(cuda, n=64, e=200, pad=10)
    torch_cfg = at.KernelConfig("torch")
    with pytest.raises(ValueError, match="torch"):
        ops.fused_gcn_layer(h, csr, inv, wm, b, config=torch_cfg)
    with pytest.raises(ValueError, match="torch"):
        ops.csr_aggregate(h, csr, inv, config=torch_cfg)
    with at.override(torch_cfg), pytest.raises(ValueError, match="torch"):
        layers.gcn_layer({"w": wm, "b": b}, h, csr, torch.ones(64,
                                                               device=cuda))
    assert at.fallback_config(cuda) == at.FALLBACK
    assert at.backend_key(cuda).startswith("cuda/")
