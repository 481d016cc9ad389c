"""The port's serving commands (``python -m repro_torch.serving replay |
serve | client``) on the CPU, against the reference package's.

Pins: ``replay`` trains and exports a bundle on a miss and reuses it on a
hit (no second training), ``--rebuild`` retrains, an explicit ``--bundle``
skips the export; served known-node labels equal the offline answer key
(exact) and the zero-neighbour query degrades; ``--bench-json`` appends
rows with the reference row's keys less its two compile counts, plus
``warm_buckets``, ``device``, ``gpu_name`` and ``power_limit_w``; a bundle
under another partitioner spec is a hard ``StaleServingArtifact``; each
package's ``replay --bundle`` serves the other's bundle with no mismatch;
the port's TCP server answers the port's and the reference's clients, with
labels equal to the offline key, and answers ``meta``, ``stats``, bad JSON
and an unknown op as the reference's server does.

Every server binds port 0 and is shut down in ``finally``; every socket,
wait and join has a timeout; nothing is written outside the tests' temp
directories.
"""
import contextlib
import io
import json
import os
import shutil
import socket
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import PartitionerSpec                         # noqa: E402
from repro.pipeline import Pipeline                            # noqa: E402
from repro.pipeline import PipelineConfig as RefConfig         # noqa: E402
from repro.serving import cli as ref_cli                       # noqa: E402
from repro_torch.pipeline import pipeline as port_pipeline     # noqa: E402
from repro_torch.serving import cli                            # noqa: E402
from repro_torch.serving.store import (EmbeddingStore,         # noqa: E402
                                       StaleServingArtifact)

TIMEOUT = 30.0
QUERIES = 300
# arxiv-like at 500 nodes, k = 4, a 16-wide GCN trained for 2 epochs
EXPORT = ["--device", "cpu", "--dataset", "arxiv-like", "--nodes", "500",
          "--k", "4", "--epochs", "2", "--classifier-epochs", "3",
          "--hidden-dim", "16", "--embed-dim", "16"]
REPLAY = ["replay", *EXPORT, "--queries", str(QUERIES), "--json"]
COMPILE_KEYS = {"warm_compiles", "steady_state_recompiles"}
PORT_ONLY_KEYS = {"warm_buckets", "device", "gpu_name", "power_limit_w"}


def _run(fn, *args):
    """(return value, JSON object printed to stdout) of ``fn(*args)``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, json.loads(buf.getvalue())


@contextlib.contextmanager
def _counting_trainings():
    """Counts the port's ``run_training`` calls (the export on a miss)."""
    calls = []
    real = port_pipeline.run_training

    def spy(*args, **kwargs):
        calls.append(args[0])
        return real(*args, **kwargs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_pipeline, "run_training", spy)
        yield calls


def _bundle_name(method="leiden_fusion"):
    return f"serving-{PartitionerSpec.parse(method).fingerprint()}.npz"


@pytest.fixture(scope="module")
def replayed(tmp_path_factory):
    """The CLI's replay twice into one bundle dir (a miss, then a hit),
    both appending to one bench file."""
    tmp = tmp_path_factory.mktemp("replay")
    bundle_dir, bench = tmp / "bundles", tmp / "rows.json"
    argv = REPLAY + ["--bundle-dir", str(bundle_dir),
                     "--bench-json", str(bench)]
    out = {"bundle": bundle_dir / _bundle_name(), "bench": bench}
    with _counting_trainings() as calls:
        out["miss"] = _run(cli.main, argv)
        out["trainings_after_miss"] = len(calls)
        out["mtime"] = os.stat(out["bundle"]).st_mtime_ns
        out["hit"] = _run(cli.main, argv)
        out["trainings_after_hit"] = len(calls)
    return out


@pytest.fixture(scope="module")
def ref_row(replayed):
    """The reference's ``cmd_replay`` serving the port's bundle."""
    args = ref_cli.build_parser().parse_args(
        ["replay", "--bundle", str(replayed["bundle"]), "--bench-json",
         "none", "--json", "--queries", str(QUERIES)])
    rc, row = _run(ref_cli.cmd_replay, args)
    assert rc == 0
    return row


def test_replay_trains_on_a_miss_and_reuses_on_a_hit(replayed):
    assert replayed["trainings_after_miss"] == 1
    assert replayed["trainings_after_hit"] == 1
    assert os.stat(replayed["bundle"]).st_mtime_ns == replayed["mtime"]
    assert os.listdir(replayed["bundle"].parent) == [_bundle_name()]
    for key in ("miss", "hit"):
        rc, row = replayed[key]
        assert rc == 0
        assert row["partition_fingerprint"] == \
            PartitionerSpec.parse("leiden_fusion").fingerprint()
        assert (row["n"], row["k"]) == (500, 4)


@pytest.mark.parametrize("key", ["miss", "hit"])
def test_replay_matches_the_offline_key_and_degrades(replayed, key):
    _, row = replayed[key]
    assert row["queries"] == QUERIES
    assert row["label_mismatches"] == 0
    assert row["served_by_source"]["degraded"] == 1
    assert sum(row["served_by_source"].values()) == QUERIES


def test_bench_json_appends_rows_with_the_reference_keys(replayed, ref_row):
    with open(replayed["bench"]) as f:
        rows = json.load(f)
    assert len(rows) == 2
    want = (set(ref_row) - COMPILE_KEYS) | PORT_ONLY_KEYS | {"ts"}
    for row, printed in zip(rows, (replayed["miss"][1], replayed["hit"][1])):
        assert set(row) == want
        assert {k: v for k, v in row.items() if k != "ts"} == printed
        assert row["device"] == "cpu"
        assert row["use_kernel"] is False
        assert row["gpu_name"] is None and row["power_limit_w"] is None
        assert row["warm_buckets"] == 7          # 1, 2, ..., 64
        assert row["wall_s"] == round(row["wall_s"], 3)
        assert row["throughput_qps"] == round(row["throughput_qps"], 1)
    assert rows[0]["ts"] < rows[1]["ts"]


def test_reference_replay_serves_the_port_bundle(ref_row):
    assert ref_row["label_mismatches"] == 0
    assert ref_row["queries"] == QUERIES
    assert ref_row["served_by_source"]["degraded"] == 1


def test_rebuild_retrains_and_an_explicit_bundle_skips_the_export(
        replayed, tmp_path):
    bundle_dir = tmp_path / "bundles"
    bundle_dir.mkdir()
    shutil.copy(replayed["bundle"], bundle_dir)
    with _counting_trainings() as calls:
        rc, row = _run(cli.main, REPLAY + ["--bundle-dir", str(bundle_dir),
                                           "--rebuild"])
        assert rc == 0 and len(calls) == 1
        assert row["label_mismatches"] == 0
        empty = tmp_path / "empty"
        rc, row = _run(cli.main, REPLAY + [
            "--bundle-dir", str(empty), "--bundle", str(replayed["bundle"])])
        assert rc == 0 and len(calls) == 1
        assert row["label_mismatches"] == 0
    assert not empty.exists()


def test_a_bundle_under_another_spec_is_a_hard_error(replayed, tmp_path):
    metis = PartitionerSpec.parse("metis").fingerprint()
    with pytest.raises(StaleServingArtifact, match="fingerprint"):
        EmbeddingStore.load(str(replayed["bundle"]), device="cpu",
                            expect_fingerprint=metis)
    # a file under metis's name that holds the leiden_fusion bundle
    shutil.copy(replayed["bundle"], tmp_path / _bundle_name("metis"))
    with _counting_trainings() as calls:
        with pytest.raises(StaleServingArtifact, match="re-export"):
            cli.main(REPLAY + ["--method", "metis",
                               "--bundle-dir", str(tmp_path)])
        # an explicit path skips the key, as in the reference
        rc, row = _run(cli.main, REPLAY + [
            "--method", "metis", "--bundle", str(replayed["bundle"])])
    assert calls == []
    assert rc == 0 and row["label_mismatches"] == 0


def test_serving_needs_the_classifier_stage(tmp_path):
    with pytest.raises(ValueError, match="serving_dir requires the "
                                         "classifier stage"):
        cli.main(REPLAY + ["--bundle-dir", str(tmp_path),
                           "--classifier-epochs", "0"])
    assert not any(tmp_path.iterdir())


def test_port_replay_serves_a_reference_bundle(tmp_path):
    ref_dir = tmp_path / "ref"
    report = Pipeline(RefConfig(
        dataset="arxiv-like", method="leiden_fusion", k=4, seed=0,
        mode="local", hidden_dim=16, embed_dim=16, epochs=2,
        classifier_epochs=3, collect_hlo=False, shard_data_axis=False,
        serving_dir=str(ref_dir), dataset_kwargs={"n": 500})).run()
    assert os.path.basename(report.serving_path) == _bundle_name()
    with _counting_trainings() as calls:
        rc, row = _run(cli.main, REPLAY + ["--bundle", report.serving_path])
        assert rc == 0 and row["label_mismatches"] == 0
        # the reference's file name is the port's key: a hit
        rc, row = _run(cli.main, REPLAY + ["--bundle-dir", str(ref_dir)])
        assert rc == 0 and row["label_mismatches"] == 0
    assert calls == []
    assert row["served_by_source"]["degraded"] == 1


# ---------------------------------------------------------------------------
# serve / client
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def server(replayed):
    """The port's server on a free port, serving the replay's bundle."""
    args = cli.build_parser().parse_args(
        ["serve", "--device", "cpu", "--port", "0",
         "--bundle", str(replayed["bundle"])])
    srv, state = cli.make_server(args)
    thread = threading.Thread(target=srv.serve_forever,
                              kwargs={"poll_interval": 0.05}, daemon=True)
    thread.start()
    try:
        host, port = srv.server_address[:2]
        yield {"host": host, "port": port, "store": state.store,
               "state": state}
    finally:
        srv.shutdown()
        srv.server_close()
        state.close(TIMEOUT)
        thread.join(TIMEOUT)
        assert not thread.is_alive()
        assert not state.pump_thread.is_alive()


def _lines(server, payloads):
    """Raw request lines on one connection; one parsed reply each."""
    with socket.create_connection((server["host"], server["port"]),
                                  timeout=TIMEOUT) as s:
        rf, wf = s.makefile("rb"), s.makefile("wb")
        out = []
        for p in payloads:
            wf.write(p + b"\n")
            wf.flush()
            out.append(json.loads(rf.readline()))
        return out


def _client_args(parser, server, *extra):
    return parser.parse_args(
        ["client", "--host", server["host"], "--port", str(server["port"]),
         "--queries", "200", "--concurrency", "4", "--json", *extra])


def test_port_client_against_the_port_server(server):
    rc, out = _run(cli.cmd_client, _client_args(
        cli.build_parser(), server, "--device", "cpu"))
    assert rc == 0
    assert out["queries"] == 200 and out["concurrency"] == 4
    assert sum(out["served_by_source"].values()) == 200
    assert out["served_by_source"]["degraded"] == 1
    assert "?" not in out["served_by_source"]
    assert out["fingerprint"] == server["store"].fingerprint


def test_reference_client_against_the_port_server(server):
    rc, out = _run(ref_cli.cmd_client,
                   _client_args(ref_cli.build_parser(), server))
    assert rc == 0
    assert out["queries"] == 200
    assert out["served_by_source"]["degraded"] == 1
    assert "?" not in out["served_by_source"]
    assert out["fingerprint"] == server["store"].fingerprint


def test_served_labels_equal_the_offline_key(server):
    store = server["store"]
    rng = np.random.default_rng(0)
    nodes = rng.integers(0, store.n, size=96)
    requests = [{"op": "query", "id": i, "node": int(v)}
                for i, v in enumerate(nodes)]
    nbs = rng.integers(0, store.n, size=(8, 5))
    requests += [{"op": "query", "node": store.n + j,
                  "neighbors": [int(x) for x in nbs[j]] if j else []}
                 for j in range(8)]
    replies, lats, _ = cli.send_queries(server["host"], server["port"],
                                        requests, concurrency=4,
                                        timeout=TIMEOUT)
    known, unseen = replies[:96], replies[96:]
    assert [r["id"] for r in known] == list(range(96))
    assert [r["node"] for r in known] == nodes.tolist()
    assert [r["label"] for r in known] == \
        store.predictions[nodes].tolist()
    assert all(r["source"] in ("store", "cache") for r in known)
    assert [r["source"] for r in unseen] == ["degraded"] + ["inductive"] * 7
    assert all(0 <= r["shard"] < store.k for r in replies)
    assert len(lats) == len(requests) and min(lats) > 0


def test_meta_stats_and_errors_as_the_reference_answers(server):
    store = server["store"]
    meta, stats, bad, unknown, blank = _lines(server, [
        b'{"op": "meta"}', b'{"op": "stats"}', b"not json",
        b'{"op": "nope"}', b""])
    assert meta == {"n": store.n, "k": store.k,
                    "num_classes": store.num_classes,
                    "embed_dim": store.embed_dim,
                    "fingerprint": store.fingerprint}
    for key in ("flushes", "flush_reasons", "queries_served", "max_batch",
                "max_wait_ms", "buckets", "per_shard_served", "cache"):
        assert key in stats
    assert stats["max_batch"] == 64
    assert bad == {"error": "bad json"} == blank
    assert unknown == {"error": "unknown op 'nope'"}
    # a line with no "op" is a query, as in the reference
    (again,) = _lines(server, [b'{"node": 0}'])
    assert again["label"] == int(store.predictions[0])
