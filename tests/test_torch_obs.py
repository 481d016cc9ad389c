"""``repro_torch.obs`` against ``tests/test_obs.py``'s contracts, and against
the reference package's ``repro.obs``.

* Every test of ``tests/test_obs.py`` has a counterpart here, run against
  the port: the shared no-op span, nesting and exception safety, the trace
  document's schema, ``validate_trace``'s require rule and its rejections,
  ``summarize``, the registry and its pow2 buckets, counter snapshots
  equal across processes, and the pipeline pin (tracing changes no output,
  and every stage's timing is its span's duration). The out-of-core
  ``graphstore.chunk`` span is not required: the out-of-core code is not
  ported.
* Across packages: the reference's ``validate_trace`` accepts the port's
  trace, ``format_summary`` of one document is the same string in both,
  and each package's CLI reads the other's trace files.
* Counter parity: the port's and the reference's pipelines (local mode,
  fresh partitions) and a 500-query replay on karate and on arxiv-like at
  2,000 nodes give equal counter and histogram snapshots on every shared
  name; ``EXCLUDED`` lists each name only one package has, with why.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs                                     # noqa: E402
from repro_torch.obs.metrics import (MetricsRegistry,            # noqa: E402
                                     pow2_bucket_index)
from repro_torch.obs.summarize import (format_summary,           # noqa: E402
                                       load_trace, summarize_trace,
                                       validate_trace)
from repro_torch.pipeline.pipeline import (PipelineConfig,       # noqa: E402
                                           PipelineReport, run_training)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REQUIRED = ["dataset", "partition", "train", "classifier"]


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep \
        + env.get("PYTHONPATH", "")
    return env


@pytest.fixture(autouse=True)
def _obs_isolation():
    obs.reset()
    yield
    obs.reset()


# ---------------------------------------------------------------------------
# spans: no-op fast path, nesting, exception safety
# ---------------------------------------------------------------------------
def test_disabled_span_is_shared_noop_singleton():
    assert not obs.enabled()
    s1 = obs.span("a.b", x=1)
    s2 = obs.span("c.d")
    assert s1 is s2
    with s1 as sp:
        sp.set(anything=True)
    assert sp.duration is None
    assert obs.tracer().event_count() == 0


def test_span_nesting_records_depth_and_containment():
    obs.enable()
    with obs.span("outer.stage") as outer:
        with obs.span("inner.step", i=0) as inner:
            pass
        with obs.span("inner.step", i=1):
            pass
    spans = obs.tracer().spans()
    assert [s.name for s in spans] == \
        ["inner.step", "inner.step", "outer.stage"]
    assert outer.depth == 0 and inner.depth == 1
    assert all(s.duration is not None and s.duration >= 0 for s in spans)
    assert outer.duration >= inner.duration


def test_span_exception_safety_stamps_error_and_unwinds():
    obs.enable()
    with pytest.raises(ValueError):
        with obs.span("boom.outer"):
            with obs.span("boom.inner"):
                raise ValueError("expected")
    spans = {s.name: s for s in obs.tracer().spans()}
    assert set(spans) == {"boom.outer", "boom.inner"}
    assert spans["boom.inner"].attrs["error"] == "ValueError"
    assert spans["boom.outer"].attrs["error"] == "ValueError"
    assert all(s.duration is not None for s in spans.values())
    with obs.span("after.exc") as sp:
        pass
    assert sp.depth == 0


def test_generator_abandonment_closes_orphaned_spans():
    obs.enable()

    def gen():
        with obs.span("gen.chunk"):
            yield 1
            yield 2

    with obs.span("consumer.loop"):
        for _ in gen():
            break
    names = [s.name for s in obs.tracer().spans()]
    assert "gen.chunk" in names and "consumer.loop" in names
    assert all(s.duration is not None for s in obs.tracer().spans())


# ---------------------------------------------------------------------------
# trace document: schema, export round trip, validate, summarize
# ---------------------------------------------------------------------------
def test_trace_document_is_valid_chrome_trace(tmp_path):
    obs.enable()
    with obs.span("pipeline.total"):
        with obs.span("pipeline.dataset", n=34):
            pass
    obs.counter("partition.sweeps").inc(3)
    path = obs.export_trace(str(tmp_path / "t.json"))
    doc = load_trace(path)
    assert validate_trace(doc) == []
    assert doc["schema"] == "repro-obs-trace"
    assert doc["version"] == obs.SCHEMA_VERSION == 1
    assert doc["displayTimeUnit"] == "ms"
    meta = [e for e in doc["traceEvents"] if e.get("ph") == "M"]
    assert meta[0]["args"]["name"] == "repro_torch"
    xs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert {e["name"] for e in xs} == {"pipeline.total", "pipeline.dataset"}
    for e in xs:
        assert e["dur"] >= 0 and "ts" in e and "pid" in e and "tid" in e
        assert e["cat"] == "pipeline"
        assert "depth" in e["args"]
    assert doc["metrics"]["partition.sweeps"]["value"] == 3


@pytest.mark.parametrize("req,ok", [("pipeline.dataset", True),
                                    ("pipeline", True), ("dataset", True),
                                    ("train", False)])
def test_validate_trace_require_matching(req, ok):
    obs.enable()
    with obs.span("pipeline.dataset"):
        pass
    assert (validate_trace(obs.trace_document(), require=[req]) == []) == ok


@pytest.mark.parametrize("doc,word", [
    ({}, "schema"),
    ({"schema": "wrong", "version": 1, "traceEvents": []}, "schema"),
    ({"schema": "repro-obs-trace", "version": "1",
      "traceEvents": [{"ph": "X", "name": "a", "ts": 0.0, "dur": 1.0,
                       "pid": 1, "tid": 1}]}, "version"),
    ({"schema": "repro-obs-trace", "version": 1,
      "traceEvents": [{"ph": "X", "name": "a", "ts": 0.0, "dur": -5.0,
                       "pid": 1, "tid": 1}]}, "dur"),
    ({"schema": "repro-obs-trace", "version": 1,
      "traceEvents": [{"ph": "X", "name": "a", "dur": 1.0, "pid": 1,
                       "tid": 1}]}, "ts"),
])
def test_validate_trace_flags_malformed_documents(doc, word):
    problems = validate_trace(doc)
    assert problems and any(word in p for p in problems)


def test_summarize_aggregates_per_name():
    obs.enable()
    for i in range(3):
        with obs.span("engine.sweep", i=i):
            pass
    doc = obs.trace_document()
    row = next(r for r in summarize_trace(doc) if r["name"] == "engine.sweep")
    assert row["count"] == 3
    assert "engine.sweep" in format_summary(doc)


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------
def test_registry_counter_gauge_histogram_snapshot():
    reg = MetricsRegistry()
    reg.counter("c").inc()
    reg.counter("c").inc(4)
    reg.gauge("g").set(2.5)
    for v in (1, 2, 3, 900):
        reg.histogram("h").record(v)
    snap = reg.snapshot()
    assert snap["c"] == {"kind": "counter", "value": 5}
    assert snap["g"]["value"] == 2.5
    h = snap["h"]["value"]
    assert h["count"] == 4 and h["min"] == 1 and h["max"] == 900
    assert h["buckets"] == {"le=2^0": 1, "le=2^1": 1, "le=2^2": 1,
                            "le=2^10": 1}
    assert reg.total_ops() == 7
    assert list(reg.snapshot(kinds=("counter",))) == ["c"]
    with pytest.raises(TypeError):
        reg.gauge("c")


@pytest.mark.parametrize("value,index", [(0, 0), (1, 0), (2, 1), (3, 2),
                                         (1024, 10), (1025, 11), (2.5, 2),
                                         (2.0 ** 70, 63)])
def test_pow2_bucket_index(value, index):
    assert pow2_bucket_index(value) == index


_SNAPSHOT_SCRIPT = """
import json, sys
from repro_torch.obs.metrics import MetricsRegistry
reg = MetricsRegistry()
for i in range(100):
    reg.counter("a.ops").inc()
    if i % 3 == 0:
        reg.counter("b.ops").inc(2)
reg.gauge("ignored.gauge").set(1.0)
print(json.dumps(reg.snapshot(kinds=("counter",)), sort_keys=True))
"""


def test_counter_snapshot_deterministic_across_processes():
    outs = [subprocess.run([sys.executable, "-c", _SNAPSHOT_SCRIPT],
                           capture_output=True, text=True, check=True,
                           env=_child_env(), timeout=120).stdout
            for _ in range(2)]
    assert outs[0] == outs[1]
    assert json.loads(outs[0]) == {"a.ops": {"kind": "counter", "value": 100},
                                   "b.ops": {"kind": "counter", "value": 68}}


# ---------------------------------------------------------------------------
# memory sampler and the profiler session
# ---------------------------------------------------------------------------
def test_memory_sample_on_the_cpu_sets_no_device_gauge():
    obs.sample_memory_now()
    gauges = obs.registry().snapshot(kinds=("gauge",))
    assert gauges["process.peak_rss_bytes"]["value"] > 0
    assert not any(name.startswith("cuda.") for name in gauges)


def test_profiler_that_cannot_start_is_counted_and_body_runs(monkeypatch,
                                                             tmp_path):
    import torch.profiler

    def broken(**_):
        raise RuntimeError("profiler unavailable")
    monkeypatch.setattr(torch.profiler, "profile", broken)
    ran = []
    with obs.profiler_session(str(tmp_path / "prof")) as session:
        ran.append(True)
    assert ran and session.path is None
    assert obs.counter("torch.profiler.failed").value == 1
    assert not (tmp_path / "prof").exists()


# ---------------------------------------------------------------------------
# the pipeline: tracing changes no output; timings are the spans
# ---------------------------------------------------------------------------
# timing key -> span name, for every stage of a training run
STAGE_SPANS = {"total": "pipeline.total", "dataset": "pipeline.dataset",
               "partition_stage": "pipeline.partition",
               "partition_eval": "pipeline.partition_eval",
               "to_device": "pipeline.to_device", "train": "pipeline.train",
               "classifier": "pipeline.classifier",
               "checkpoint": "pipeline.checkpoint",
               "classify": "pipeline.classify"}
MODES = {"local": {}, "low_memory": {"low_memory": True},
         "sync": {"mode": "sync"},
         "stale": {"mode": "stale", "sync_period": 2}}


def _tiny(tmp_path, mode):
    cfg = PipelineConfig(dataset="karate", k=2, epochs=3,
                         classifier_epochs=4, hidden_dim=16, embed_dim=16,
                         num_layers=2, classifier_hidden=32,
                         checkpoint_dir=str(tmp_path / "ckpt"),
                         **MODES[mode])
    result = run_training(cfg, device="cpu")
    return cfg, result, PipelineReport.of(cfg, result).as_dict()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_noop_mode_byte_identical_and_timings_pin(tmp_path, mode):
    assert not obs.enabled()
    _, plain_result, plain = _tiny(tmp_path, mode)
    assert obs.tracer().event_count() == 0

    obs.reset()
    obs.enable()
    cfg, traced_result, traced = _tiny(tmp_path, mode)

    plain.pop("timings")
    timings = traced.pop("timings")
    assert json.dumps(plain, sort_keys=True, default=str) == \
        json.dumps(traced, sort_keys=True, default=str)
    np.testing.assert_array_equal(plain_result.losses, traced_result.losses)
    assert torch.equal(plain_result.embeddings, traced_result.embeddings)

    spans = obs.tracer().spans()
    durations = {s.name: s.duration for s in spans}
    # the low-memory run gathers one partition at a time, in its train stage
    keys = set(STAGE_SPANS) - ({"to_device"} if mode == "low_memory"
                               else set())
    assert keys <= set(timings)
    for key in sorted(keys):
        name = STAGE_SPANS[key]
        assert timings[key] == round(durations[name], 4), key
        assert traced_result.timings[key] == durations[name], key
    partition = next(s for s in spans if s.name == "pipeline.partition")
    assert partition.attrs["cache_hit"] is False
    assert validate_trace(obs.trace_document(), require=REQUIRED) == []

    names = {s.name for s in spans}
    assert {"engine.sweep", "engine.quotient", "engine.split_components",
            "partition.local_move"} <= names
    counters = obs.registry().snapshot(kinds=("counter",))
    epochs = [s for s in spans if s.name == "train.epoch"]
    if mode == "low_memory":
        parts = [s for s in spans if s.name == "train.partition"]
        assert not epochs and len(parts) == cfg.k
        assert all("loss" in s.attrs for s in parts)
        assert counters["train.epochs"]["value"] == cfg.epochs * cfg.k
    else:
        assert [s.attrs["epoch"] for s in epochs] == list(range(cfg.epochs))
        assert {s.attrs["mode"] for s in epochs} == {cfg.mode}
        assert all("loss" in s.attrs for s in epochs)
        assert counters["train.epochs"]["value"] == cfg.epochs
    if mode == "stale":
        kinds = [s.attrs["kind"] for s in epochs]
        assert kinds == ["exchange", "stale", "exchange"]
        assert counters["train.stale_exchanges"]["value"] == 2
    else:
        assert "train.stale_exchanges" not in counters or \
            counters["train.stale_exchanges"]["value"] == 0
    gauges = obs.registry().snapshot(kinds=("gauge",))
    assert gauges["train.collective_bytes_per_step"]["value"] == \
        traced_result.collectives["total"]
    assert "train.loss" in gauges and "process.peak_rss_bytes" in gauges


# ---------------------------------------------------------------------------
# across packages: one trace format
# ---------------------------------------------------------------------------
@pytest.fixture
def port_trace(tmp_path):
    obs.enable()
    _tiny(tmp_path, "local")
    path = obs.export_trace(str(tmp_path / "port.json"))
    obs.reset()
    return path


def test_reference_validates_and_summarizes_the_port_trace(port_trace):
    from repro.obs import summarize as ref_summarize
    doc = load_trace(port_trace)
    assert ref_summarize.validate_trace(doc, require=REQUIRED) == []
    assert ref_summarize.format_summary(doc) == format_summary(doc)
    assert ref_summarize.format_summary(doc, top=5) == \
        format_summary(doc, top=5)
    assert ref_summarize.summarize_trace(doc) == summarize_trace(doc)


def _reference_trace(path):
    from repro import obs as ref_obs
    ref_obs.reset()
    ref_obs.enable()
    try:
        with ref_obs.span("pipeline.total"):
            for name in REQUIRED:
                with ref_obs.span(f"pipeline.{name}"):
                    ref_obs.counter("partition.sweeps").inc()
        return ref_obs.export_trace(path)
    finally:
        ref_obs.reset()


@pytest.mark.parametrize("reader,writer", [("repro", "port"),
                                           ("repro_torch", "reference")])
def test_each_cli_reads_the_other_package_trace(port_trace, tmp_path, reader,
                                                writer):
    path = port_trace if writer == "port" \
        else _reference_trace(str(tmp_path / "ref.json"))
    doc = load_trace(path)
    assert format_summary(doc)
    for cmd in (["validate", path, "--require", *REQUIRED],
                ["summarize", path, "--top", "5"]):
        out = subprocess.run([sys.executable, "-m", f"{reader}.obs", *cmd],
                             capture_output=True, text=True, timeout=120,
                             env=_child_env(), cwd=ROOT)
        assert out.returncode == 0, out.stderr
        assert out.stdout
    assert "pipeline.train" in out.stdout


def test_cli_trace_profile_and_checkpoint_on_the_cpu(tmp_path):
    trace, prof, ckpt = (str(tmp_path / n) for n in
                         ("run.json", "prof", "ckpt"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.pipeline", "run", "--device",
         "cpu", "--dataset", "karate", "--k", "4", "--epochs", "2",
         "--classifier-epochs", "5", "--hidden-dim", "16", "--embed-dim",
         "16", "--num-layers", "2", "--trace", trace, "--torch-profile", prof,
         "--checkpoint-dir", ckpt],
        capture_output=True, text=True, timeout=300, env=_child_env(),
        cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "trace written" in out.stderr
    assert f"checkpoint   {os.path.join(ckpt, 'step_00000002')}" in out.stdout
    val = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "validate", trace,
         "--require", *REQUIRED], capture_output=True, text=True,
        timeout=120, env=_child_env(), cwd=ROOT)
    assert val.returncode == 0, val.stderr
    assert val.stdout.startswith("OK:")
    profiles = os.listdir(prof)
    assert len(profiles) == 1 and profiles[0].endswith(".pt.trace.json")
    with open(os.path.join(prof, profiles[0])) as f:
        assert json.load(f)["traceEvents"]
    assert os.listdir(ckpt) == ["step_00000002"]


# ---------------------------------------------------------------------------
# counter parity with the reference
# ---------------------------------------------------------------------------
# Names only one package counts, and why. Every other counter and
# histogram of either package must be in both, with equal values.
_CHUNKS = ("the reference's in-RAM Graph runs split_components and the "
           "batch assembly through its out-of-core chunk protocol "
           "(iter_csr_chunks); the out-of-core code is not ported, so the "
           "port has no chunks to count")
EXCLUDED = {"graphstore.chunks": _CHUNKS,
            "graphstore.chunk_bytes": _CHUNKS}
GRAPHS = {"karate": {}, "arxiv-like": {"n": 2000}}
DIMS = dict(k=4, epochs=2, classifier_epochs=2, hidden_dim=16, embed_dim=16,
            num_layers=2, classifier_hidden=32)
REPLAY = dict(num_queries=500, unseen_frac=0.05, seed=0)
SERVE = dict(max_batch=16, max_neighbors=8)


def _replay(pkg, path, **store_kw):
    """A 500-query replay through ``pkg``'s serving stack; the clock is
    frozen, so only full batches and the final drain flush."""
    import importlib
    store_mod = importlib.import_module(f"{pkg}.serving.store")
    batcher_mod = importlib.import_module(f"{pkg}.serving.batcher")
    cache_mod = importlib.import_module(f"{pkg}.serving.cache")
    replay_mod = importlib.import_module(f"{pkg}.serving.replay")
    store = store_mod.EmbeddingStore.load(path, **store_kw)
    batcher = batcher_mod.ContinuousBatcher(
        store, cache=cache_mod.LruNodeCache(16), now=lambda: 0.0, **SERVE)
    workload = replay_mod.make_zipf_workload(
        store.n, max_neighbors=SERVE["max_neighbors"], **REPLAY)
    return replay_mod.run_replay(batcher, workload)


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def both_snapshots(request, tmp_path_factory):
    from repro import obs as ref_obs
    from repro.pipeline import Pipeline
    from repro.pipeline import PipelineConfig as RefConfig
    name = request.param
    tmp = tmp_path_factory.mktemp("parity")
    kinds = ("counter", "histogram")

    obs.reset()
    cfg = PipelineConfig(dataset=name, dataset_kwargs=GRAPHS[name],
                         serving_dir=str(tmp / "port"), **DIMS)
    port_row = _replay("repro_torch", run_training(cfg, device="cpu")
                       .serving_path, device="cpu")
    port = obs.registry().snapshot(kinds=kinds)
    obs.reset()

    ref_obs.reset()
    try:
        report = Pipeline(RefConfig(
            dataset=name, dataset_kwargs=GRAPHS[name], cache_dir=None,
            serving_dir=str(tmp / "ref"), collect_hlo=False,
            shard_data_axis=False, **DIMS)).run()
        ref_row = _replay("repro", report.serving_path)
        ref = ref_obs.registry().snapshot(kinds=kinds)
    finally:
        ref_obs.reset()
    return name, port, ref, port_row, ref_row


def test_counter_and_histogram_snapshots_match_reference(both_snapshots):
    name, port, ref, port_row, ref_row = both_snapshots
    only_ref, only_port = set(ref) - set(port), set(port) - set(ref)
    assert only_port == set(), only_port
    assert only_ref <= set(EXCLUDED), only_ref - set(EXCLUDED)
    shared = sorted(set(port) & set(ref))
    assert {"partition.sweeps", "partition.moves", "engine.quotient_calls",
            "graphstore.gather_calls", "graphstore.gather_rows",
            "train.epochs", "serving.cache.hits", "serving.cache.misses",
            "serving.cache.evictions", "serving.flush.max_batch",
            "serving.flush.drain", "serving.batch_size"} <= set(shared)
    assert any(n.startswith("serving.bucket.classify.") for n in shared)
    assert any(n.startswith("serving.bucket.inductive.") for n in shared)
    assert {n: port[n] for n in shared} == {n: ref[n] for n in shared}
    for key in ("flushes", "flush_reasons", "cache_hit_rate",
                "served_by_source", "per_shard_served"):
        assert port_row[key] == ref_row[key], (name, key)
