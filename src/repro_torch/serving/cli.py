"""``python -m repro_torch.serving``: replay, serve, client.

    # export (or reuse) a trained 4-partition bundle, replay a 10k-query
    # Zipf workload through the continuous batcher, verify served labels
    # against the offline answer key; on the GPU
    PYTHONPATH=src python -m repro_torch.serving
    PYTHONPATH=src python -m repro_torch.serving replay --device cpu \\
        --nodes 600 --queries 500 --bench-json /tmp/rows.json

    # multi-process layout: one server, any number of clients
    PYTHONPATH=src python -m repro_torch.serving serve --port 7431 &
    PYTHONPATH=src python -m repro_torch.serving client --port 7431 \\
        --queries 2000

The commands, flags and line protocol are the reference package's
(``python -m repro.serving``), so either package's client talks to either
package's server, and either package serves the other's bundles. The
server hosts the partition-sharded store behind one continuous batcher;
clients connect concurrently and batching happens across connections. The
protocol is one JSON object per line: ``{"op": "query", "node": 17}``,
``{"op": "query", "node": 99999, "neighbors": [3, 14, 15]}`` (inductive),
``{"op": "meta"}``, ``{"op": "stats"}``.

Bundles are keyed by the partitioner-spec fingerprint: a bundle exported
under other partitioner hyperparameters is a hard error
(:class:`~repro_torch.serving.store.StaleServingArtifact`), never served;
an explicit ``--bundle`` path skips the key. On a miss, ``replay`` and
``serve`` train the bundle through the port's training pipeline.

Where the port differs from the reference:

* ``--device`` (default ``cuda``; without a GPU every command raises
  unless given ``--device cpu``). On the card the inductive aggregation is
  always the CUDA kernel, so there is no ``--use-kernel``;
* ``--bundle-dir`` defaults to the temporary directory and the partition
  cache is off unless ``--cache-dir`` is given (the reference defaults both
  to the home directory);
* ``replay --bench-json`` writes a bench row only when given a path (the
  reference appends to its benchmark folder's ``BENCH_serving.json`` by
  default); ``none`` also skips;
* the report's and the row's compile counts are ``warmup N buckets``
  (``warm_buckets``): eager PyTorch compiles nothing.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import socket
import socketserver
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

log = logging.getLogger("repro_torch.serving")

COMMANDS = ("replay", "serve", "client")
DEFAULT_BUNDLE_DIR = os.path.join(tempfile.gettempdir(),
                                  "repro_torch-serving")


# ---------------------------------------------------------------------------
# argparse
# ---------------------------------------------------------------------------
def _add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a GPU the command "
                         "raises unless told cpu")


def _add_bundle_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--bundle-dir", default=DEFAULT_BUNDLE_DIR,
                    help="directory of serving bundles (fingerprint-named; "
                         "default: under the temporary directory)")
    ap.add_argument("--bundle", default=None,
                    help="explicit bundle .npz (skips the pipeline export)")
    ap.add_argument("--dataset", default="arxiv-like")
    ap.add_argument("--nodes", type=int, default=2000,
                    help="synthetic dataset size for the export pipeline")
    ap.add_argument("--method", default="leiden_fusion",
                    help="partitioner spec; its config fingerprint keys "
                         "the bundle — mismatches are hard errors")
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--classifier-epochs", type=int, default=80)
    ap.add_argument("--hidden-dim", type=int, default=64)
    ap.add_argument("--embed-dim", type=int, default=64)
    ap.add_argument("--cache-dir", default=None,
                    help="partition artifact cache for the export pipeline "
                         "(off unless given)")
    ap.add_argument("--rebuild", action="store_true",
                    help="re-run the pipeline even if a bundle exists")
    _add_device_arg(ap)


def _add_batcher_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--cache-capacity", type=int, default=512,
                    help="LRU hot-node cache size (embedding rows)")
    ap.add_argument("--max-neighbors", type=int, default=32,
                    help="inductive fallback: neighbor-axis pad size")


def _add_workload_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--queries", type=int, default=10_000)
    ap.add_argument("--alpha", type=float, default=1.1,
                    help="Zipf exponent of the node popularity law")
    ap.add_argument("--unseen-frac", type=float, default=0.02,
                    help="fraction of queries for nodes outside the store "
                         "(answered by the inductive fallback)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serving",
        description="partition-sharded embedding serving: continuous "
                    "batching + LRU cache + inductive fallback")
    sub = ap.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser("replay", help="in-process Zipf replay (default)")
    _add_bundle_args(rp)
    _add_batcher_args(rp)
    _add_workload_args(rp)
    rp.add_argument("--bench-json", default=None,
                    help="append the run's bench row to this JSON "
                         "trajectory file; written only when a path is "
                         "given ('none' also skips). The reference's "
                         "default, benchmarks/artifacts/BENCH_serving.json, "
                         "is the JAX package's benchmark record")
    rp.add_argument("--no-verify", action="store_true",
                    help="skip the exact-match check against the offline "
                         "answer key")
    rp.add_argument("--json", action="store_true")

    sv = sub.add_parser("serve", help="host the store behind a TCP server")
    _add_bundle_args(sv)
    _add_batcher_args(sv)
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=7431,
                    help="0 binds a free port (printed when listening)")

    cl = sub.add_parser("client", help="replay a workload against a server")
    _add_workload_args(cl)
    cl.add_argument("--host", default="127.0.0.1")
    cl.add_argument("--port", type=int, default=7431)
    cl.add_argument("--concurrency", type=int, default=8,
                    help="parallel connections (batching happens across "
                         "them on the server)")
    cl.add_argument("--seed", type=int, default=0)
    cl.add_argument("--json", action="store_true")
    _add_device_arg(cl)
    return ap


# ---------------------------------------------------------------------------
# bundle resolution (export-on-miss through the training pipeline)
# ---------------------------------------------------------------------------
def _fingerprint(args) -> str:
    from repro_torch.core import PartitionerSpec
    return PartitionerSpec.parse(args.method).fingerprint()


def ensure_bundle(args) -> str:
    """Resolve the serving bundle, training and exporting one through
    :func:`~repro_torch.pipeline.pipeline.run_training` on a miss.

    Returns the bundle path; :func:`load_store` loads it with
    ``expect_fingerprint`` so a stale bundle can never be served. The key
    is the partitioner fingerprint alone, as in the reference: a bundle of
    another dataset or size under the same spec is a hit."""
    fp = _fingerprint(args)
    if args.bundle:
        return args.bundle
    bundle_dir = os.path.expanduser(args.bundle_dir)
    cand = os.path.join(bundle_dir, f"serving-{fp}.npz")
    if os.path.exists(cand) and not args.rebuild:
        log.info("serving bundle HIT: %s", cand)
        return cand
    log.info("serving bundle MISS: running the export pipeline "
             "(dataset=%s n=%d k=%d)", args.dataset, args.nodes, args.k)
    from repro_torch.pipeline.pipeline import PipelineConfig, run_training
    dataset_kwargs = {}
    if args.dataset.replace("-", "_") != "karate":
        dataset_kwargs["n"] = args.nodes
    cfg = PipelineConfig(
        dataset=args.dataset, method=args.method, k=args.k, seed=args.seed,
        mode="local", hidden_dim=args.hidden_dim, embed_dim=args.embed_dim,
        epochs=args.epochs, classifier_epochs=args.classifier_epochs,
        cache_dir=args.cache_dir, serving_dir=bundle_dir,
        dataset_kwargs=dataset_kwargs)
    result = run_training(cfg, device=args.device)
    log.info("exported serving bundle: %s (test acc %.3f)",
             result.serving_path, result.accuracy.get("test", float("nan")))
    return result.serving_path


def load_store(args):
    from .store import EmbeddingStore
    path = ensure_bundle(args)
    fp = None if args.bundle else _fingerprint(args)
    return EmbeddingStore.load(path, device=args.device,
                               expect_fingerprint=fp)


def make_batcher(store, args):
    from .batcher import ContinuousBatcher
    from .cache import LruNodeCache
    return ContinuousBatcher(
        store, cache=LruNodeCache(args.cache_capacity),
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        max_neighbors=args.max_neighbors)


# ---------------------------------------------------------------------------
# replay (the default command: the end-to-end acceptance path)
# ---------------------------------------------------------------------------
def cmd_replay(args) -> int:
    from repro_torch.device import resolve_device

    from .replay import (append_bench_rows, bench_row, make_zipf_workload,
                         run_replay)
    resolve_device(args.device)
    store = load_store(args)
    log.info("%s", store.summary())
    batcher = make_batcher(store, args)
    workload = make_zipf_workload(
        store.n, num_queries=args.queries, alpha=args.alpha,
        unseen_frac=args.unseen_frac, max_neighbors=args.max_neighbors,
        seed=args.seed)
    row = bench_row(run_replay(batcher, workload, verify=not args.no_verify))
    if args.bench_json and args.bench_json != "none":
        append_bench_rows([row], path=args.bench_json)
        log.info("BENCH row appended: %s", args.bench_json)
    if args.json:
        print(json.dumps(row, indent=2))
    else:
        srcs = ", ".join(f"{k}={v}" for k, v in
                         sorted(row["served_by_source"].items()))
        print(f"serving replay: {row['queries']} queries in "
              f"{row['wall_s']}s ({row['throughput_qps']} qps)")
        print(f"  latency      p50={row['p50_ms']}ms p99={row['p99_ms']}ms")
        print(f"  cache        hit_rate={row['cache_hit_rate']}")
        print(f"  warmup       {row['warm_buckets']} buckets")
        reasons = ", ".join(f"{k}={v}" for k, v in
                            sorted(row["flush_reasons"].items()))
        print(f"  flushes      {row['flushes']} ({reasons})")
        print(f"  answers      {srcs}")
        print(f"  exact-match  {row['queries'] - row['label_mismatches']}"
              f"/{row['queries']} (mismatches={row['label_mismatches']})")
    return 0


# ---------------------------------------------------------------------------
# serve / client (multi-process layout)
# ---------------------------------------------------------------------------
class ServingState:
    """One batcher shared by the server's handler threads.

    Handler threads only submit and wait; every ``pump`` (all device work)
    runs in the one pump thread, and every batcher call is made under
    ``lock``."""

    def __init__(self, store, batcher):
        self.store = store
        self.batcher = batcher
        self.lock = threading.Lock()
        self.answers: Dict[int, Any] = {}
        self.events: Dict[int, threading.Event] = {}
        self.closing = threading.Event()
        self.error: Optional[BaseException] = None
        self.warm_buckets = 0
        self.pump_thread = threading.Thread(target=self.pump_loop,
                                            name="serving-pump", daemon=True)

    def submit_and_wait(self, node: int, neighbors, timeout: float = 60.0):
        ev = threading.Event()
        with self.lock:
            if self.error is not None:
                raise RuntimeError("the serving pump failed") \
                    from self.error
            qid = self.batcher.submit(node, neighbors=neighbors)
            self.events[qid] = ev
        if not ev.wait(timeout):
            raise TimeoutError(f"query {qid} timed out")
        with self.lock:
            answer = self.answers.pop(qid, None)
        if answer is None:
            raise RuntimeError("the serving pump failed") from self.error
        return answer

    def pump_loop(self) -> None:
        tick = max(self.batcher.max_wait_ms / 1000.0 / 4, 1e-4)
        while not self.closing.is_set():
            events = []
            with self.lock:
                try:
                    ready = self.batcher.pump()
                except Exception as e:      # wake every waiter, then stop
                    log.exception("serving pump failed")
                    self.error = e
                    events = list(self.events.values())
                    self.events.clear()
                    self.closing.set()
                    ready = []
                for a in ready:
                    self.answers[a.qid] = a
                    ev = self.events.pop(a.qid, None)
                    if ev is not None:
                        events.append(ev)
            for ev in events:        # wake waiters outside the lock
                ev.set()
            self.closing.wait(tick)

    def close(self, timeout: float = 10.0) -> None:
        """Stop the pump thread and wait for it (at most ``timeout`` s)."""
        self.closing.set()
        if self.pump_thread.is_alive():
            self.pump_thread.join(timeout)


class _Handler(socketserver.StreamRequestHandler):
    """One connection: JSON requests in, one JSON reply line each."""

    def handle(self):
        state: ServingState = self.server.state
        store = state.store
        for raw in self.rfile:
            try:
                req = json.loads(raw)
            except ValueError:
                self._reply({"error": "bad json"})
                continue
            if not isinstance(req, dict):
                self._reply({"error": "bad json"})
                continue
            op = req.get("op", "query")
            if op == "meta":
                self._reply({"n": store.n, "k": store.k,
                             "num_classes": store.num_classes,
                             "embed_dim": store.embed_dim,
                             "fingerprint": store.fingerprint})
            elif op == "stats":
                with state.lock:
                    self._reply(state.batcher.stats())
            elif op == "query":
                try:
                    node = int(req["node"])
                except (KeyError, TypeError, ValueError):
                    self._reply({"error": "bad query"})
                    continue
                try:
                    a = state.submit_and_wait(node, req.get("neighbors"))
                except (TimeoutError, RuntimeError) as e:
                    self._reply({"error": str(e)})
                    continue
                self._reply({"id": req.get("id"), "node": a.node_id,
                             "label": a.label, "shard": a.shard,
                             "source": a.source,
                             "latency_ms": round(a.latency_ms, 3)})
            else:
                self._reply({"error": f"unknown op {op!r}"})

    def _reply(self, obj):
        self.wfile.write((json.dumps(obj) + "\n").encode())
        self.wfile.flush()


def make_server(args) -> Tuple[socketserver.ThreadingTCPServer,
                               ServingState]:
    """Load (or export) the store, warm the batcher up, bind the server
    and start the pump thread. The caller runs ``serve_forever`` and, to
    stop, ``shutdown``, ``server_close`` and ``state.close()``. With
    ``--port 0`` the bound port is ``server.server_address[1]``."""
    from repro_torch.device import resolve_device
    resolve_device(args.device)
    store = load_store(args)
    batcher = make_batcher(store, args)
    state = ServingState(store, batcher)
    state.warm_buckets = batcher.warmup()
    srv = socketserver.ThreadingTCPServer((args.host, args.port), _Handler)
    srv.daemon_threads = True
    srv.state = state
    state.pump_thread.start()
    return srv, state


def cmd_serve(args) -> int:
    srv, state = make_server(args)
    host, port = srv.server_address[:2]
    print(f"serving {state.store.summary()}")
    print(f"listening on {host}:{port} (warmup ran {state.warm_buckets} "
          f"bucket shapes; ctrl-c to stop)")
    sys.stdout.flush()
    try:
        srv.serve_forever(poll_interval=0.2)
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        state.close()
    return 0


def send_queries(host: str, port: int,
                 requests: Sequence[Dict[str, Any]], concurrency: int = 8,
                 timeout: float = 60.0
                 ) -> Tuple[List[Dict[str, Any]], List[float], float]:
    """Send ``requests`` over ``concurrency`` connections (request ``i``
    on connection ``i % concurrency``, one at a time per connection).
    Returns (replies in request order, client-side latency ms of each,
    wall seconds). Every socket has ``timeout``; a failed connection
    raises here after all of them have ended."""
    replies: List[Optional[Dict[str, Any]]] = [None] * len(requests)
    lats: List[float] = [0.0] * len(requests)
    errors: List[BaseException] = []

    def worker(wi: int) -> None:
        try:
            with socket.create_connection((host, port),
                                          timeout=timeout) as s:
                rf, wf = s.makefile("rb"), s.makefile("wb")
                for i in range(wi, len(requests), concurrency):
                    t0 = time.perf_counter()
                    wf.write((json.dumps(requests[i]) + "\n").encode())
                    wf.flush()
                    line = rf.readline()
                    if not line:
                        raise ConnectionError("server closed the connection")
                    replies[i] = json.loads(line)
                    lats[i] = (time.perf_counter() - t0) * 1000.0
        except Exception as e:          # reported after every join
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(min(concurrency, len(requests)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return replies, lats, wall


def _rpc(host: str, port: int, obj: Dict[str, Any],
         timeout: float = 60.0) -> Dict[str, Any]:
    replies, _, _ = send_queries(host, port, [obj], 1, timeout)
    return replies[0]


def run_client(args) -> Dict[str, Any]:
    """Replay a Zipf workload sized from the server's ``meta`` over
    ``--concurrency`` connections; returns the client's row."""
    import numpy as np

    from .replay import make_zipf_workload
    meta = _rpc(args.host, args.port, {"op": "meta"})
    workload = make_zipf_workload(
        int(meta["n"]), num_queries=args.queries, alpha=args.alpha,
        unseen_frac=args.unseen_frac, seed=args.seed)
    requests = []
    for i, (node, nbs) in enumerate(workload):
        req = {"op": "query", "id": i % args.concurrency, "node": int(node)}
        if nbs is not None:
            req["neighbors"] = [int(x) for x in nbs]
        requests.append(req)
    replies, lats, wall = send_queries(args.host, args.port, requests,
                                       args.concurrency)
    merged: Dict[str, int] = {}
    for r in replies:
        src = r.get("source", "?")
        merged[src] = merged.get(src, 0) + 1
    flat = np.asarray(lats)
    return {"queries": int(flat.size), "wall_s": round(wall, 3),
            "throughput_qps": round(flat.size / max(wall, 1e-9), 1),
            "p50_ms": round(float(np.percentile(flat, 50)), 3),
            "p99_ms": round(float(np.percentile(flat, 99)), 3),
            "served_by_source": merged,
            "concurrency": args.concurrency,
            "server": f"{args.host}:{args.port}",
            "fingerprint": meta["fingerprint"]}


def cmd_client(args) -> int:
    from repro_torch.device import resolve_device
    resolve_device(args.device)
    out = run_client(args)
    print(json.dumps(out, indent=2) if args.json else
          f"client: {out['queries']} queries, {out['throughput_qps']} qps, "
          f"p50={out['p50_ms']}ms p99={out['p99_ms']}ms, "
          f"sources={out['served_by_source']}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or (argv[0] not in COMMANDS
                    and argv[0] not in ("-h", "--help")):
        argv = ["replay"] + argv     # `python -m repro_torch.serving [...]`
    args = build_parser().parse_args(argv)
    if args.cmd == "replay":
        return cmd_replay(args)
    if args.cmd == "serve":
        return cmd_serve(args)
    return cmd_client(args)


if __name__ == "__main__":
    sys.exit(main())
