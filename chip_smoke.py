#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. print the card (``nvidia-smi`` name and power limit);
2. build the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, in parallel) and print the build time and register use;
3. main path at ogbn-arxiv scale (169,343 nodes, 128 features, 40 classes):
   Leiden-Fusion with k = 8 (repli), a 3-layer 128-wide GCN and a 256-wide
   classifier with seeded weights, pooled table, bundle export and load,
   ``warmup()``, then 2,000 Zipf queries with 10% unseen nodes. Every
   known-node answer must equal the offline key, and both kernels must
   have launched during this run;
4. checks: the inductive logits of one batch against the plain path on the
   same batch; the whole pipeline on karate on the card against the plain
   CPU path;
5. each kernel against its plain version at the main path's shapes, with
   its time (CUDA events, median of 30), the plain version's time, a
   PyTorch library call's time where one computes the same function, and
   the bound: the larger of bytes moved over 3.35 TB/s and operations over
   67 TFLOP/s (H100 SXM f32 without tensor cores, published peaks at 700 W).

It prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as
its last line ``{"ok": true, "device": {...}}``. Without a GPU, or without
the rest of the repository beside it, it exits non-zero before any result.
"""
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TOL = dict(rtol=3e-5, atol=3e-5)
ARXIV_SCALE = 169343 / 40000
QUERIES = 2000
MAX_NEIGHBORS = 32


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke failed: {what}")


def time_ms(fn, iters=30, warmup=3):
    """Median device time of one call, by CUDA events around each call."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes, ops):
    """(bound in ms, what bounds it) for the given bytes and f32 ops."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_err(out, ref):
    """Max abs error; fails unless |out - ref| <= atol + rtol*|ref|."""
    import torch
    check(bool(torch.isfinite(out).all()), "non-finite kernel output")
    diff = (out - ref).abs()
    check(bool((diff <= TOL["atol"] + TOL["rtol"] * ref.abs()).all()),
          f"kernel disagrees with its plain version: max abs err "
          f"{float(diff.max())}")
    return float(diff.max())


def main():
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import csr_aggregate as kernel_a
    from repro_torch.kernels import fused_layer as kernel_b
    from repro_torch.pipeline.datasets import graph_fingerprint
    from repro_torch.pipeline.pipeline import PipelineConfig, run_inference
    from repro_torch.serving.batcher import ContinuousBatcher
    from repro_torch.serving.cache import LruNodeCache
    from repro_torch.serving.inductive import aggregate_and_head
    from repro_torch.serving.replay import make_zipf_workload, run_replay
    from repro_torch.serving.store import EmbeddingStore, classify

    # f32 products stay f32 (the reference's parity); the defaults, stated
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. the card ----------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for {sorted(built)}")
    for name, (_, log) in built.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke-", dir=ROOT) as tmp:
        # -- 3. the main path ---------------------------------------------
        cfg = PipelineConfig(dataset="arxiv-like", k=8, scheme="repli",
                             serving_dir=tmp,
                             dataset_kwargs={"scale": ARXIV_SCALE})
        ops.reset_launch_counts()
        result = run_inference(cfg, device=dev)
        store = EmbeddingStore.load(
            result.serving_path, device=dev,
            expect_fingerprint=cfg.partitioner.fingerprint(),
            expect_graph=graph_fingerprint(result.dataset.graph))
        batcher = ContinuousBatcher(store, cache=LruNodeCache(512),
                                    max_batch=64, max_wait_ms=2.0,
                                    max_neighbors=MAX_NEIGHBORS)
        workload = make_zipf_workload(store.n, num_queries=QUERIES,
                                      unseen_frac=0.1,
                                      max_neighbors=MAX_NEIGHBORS, seed=0)
        row = run_replay(batcher, workload, verify=False)
        torch.cuda.synchronize()
        launches = ops.launch_counts()

    t = result.timings
    n, emb_dim = result.embeddings.shape
    print(f"main path: n={n} k={result.batch.k} n_pad={result.batch.n_pad} "
          f"e_pad={result.batch.e_pad} E={emb_dim}")
    print("timings_s: " + " ".join(f"{k}={v:.3f}" for k, v in t.items()))
    print(f"partition_s={t['partition']:.3f} embed_s={t['embed']:.4f} "
          f"qps={row['throughput_qps']:.1f} p50_ms={row['p50_ms']:.3f} "
          f"p99_ms={row['p99_ms']:.3f}")
    print(f"replay: {json.dumps(row, sort_keys=True)}")
    print(f"launches: {json.dumps(launches)}")
    check((n, emb_dim) == (169343, 128), f"table shape {(n, emb_dim)}")
    check(bool(torch.isfinite(result.embeddings).all()),
          "non-finite embeddings")
    if row["label_mismatches"]:
        ids = torch.as_tensor(row["mismatched_nodes"], device=dev)
        top2 = classify(store.classifier,
                        result.embeddings[ids]).topk(2).values
        print(f"mismatched nodes {row['mismatched_nodes']}: offline logit "
              f"margins {(top2[:, 0] - top2[:, 1]).tolist()}")
    check(row["label_mismatches"] == 0,
          f"{row['label_mismatches']} of {row['known_queries']} known-node "
          f"answers differ from the offline key")
    check(row["served_by_source"].get("degraded") == 1,
          "the zero-neighbour query did not degrade")
    check(launches["fused_gcn_layer"] > 0 and launches["csr_aggregate"] > 0,
          f"a kernel of the main path never launched: {launches}")

    # -- 4. checks against the plain path --------------------------------
    unseen = [nb for node, nb in workload if node >= store.n][:64]
    nb_emb, nb_mask, pids = batcher.inductive.prepare(unseen, 64)
    pid_t = torch.as_tensor(pids, device=dev)
    head_w, head_b = store.head_w[pid_t], store.head_b[pid_t]
    agg, logits = aggregate_and_head(nb_emb, nb_mask, head_w, head_b)
    p_agg, p_logits = aggregate_and_head(nb_emb.cpu(), nb_mask.cpu(),
                                         head_w.cpu(), head_b.cpu())
    err = (logits.cpu() - p_logits).abs().max().item()
    print(f"inductive check: max abs logit err {err:.3e} "
          f"(tol 1e-5 + 1e-5*|ref|)")
    check(torch.allclose(logits.cpu(), p_logits, rtol=1e-5, atol=1e-5)
          and torch.allclose(agg.cpu(), p_agg, rtol=1e-5, atol=1e-5),
          f"inductive path disagrees with the plain path ({err})")
    small = PipelineConfig(dataset="karate", k=4, hidden_dim=16,
                           embed_dim=16, classifier_hidden=32)
    on_card = run_inference(small, device=dev)
    on_cpu = run_inference(small, device="cpu")
    err = (on_card.embeddings.cpu() - on_cpu.embeddings).abs().max().item()
    print(f"karate check: max abs table err {err:.3e} "
          f"(tol 1e-4 + 1e-4*|ref|), answer keys equal: "
          f"{bool((on_card.predictions == on_cpu.predictions).all())}")
    check(torch.allclose(on_card.embeddings.cpu(), on_cpu.embeddings,
                         rtol=1e-4, atol=1e-4)
          and (on_card.predictions == on_cpu.predictions).all(),
          "karate pipeline on the card disagrees with the CPU path")

    # -- 5. kernels against their plain versions, timed -----------------
    kernels = []
    tens, params = result.tensors, result.params
    p = int(torch.argmax((tens.edge_weight > 0).sum(dim=1)))   # most arcs
    csr = ops.to_csr(tens.edge_src[p], tens.edge_dst[p],
                     tens.edge_weight[p], result.batch.n_pad)
    h = tens.features[p].contiguous()
    inv = ops.inv_degree(tens.in_degree[p])
    w0 = params["body"]["layers"][0]["w"][p]
    b0 = params["body"]["layers"][0]["b"][p]
    nn, f = h.shape
    fo, e = w0.shape[1], csr.src.shape[0]
    e_live = int((csr.weight > 0).sum())
    errs = []
    for activate in (True, False):
        out, _ = kernel_b.launch(h, csr.src, csr.row_ptr, csr.weight, inv,
                                 w0, b0, activate=activate)
        ref = kernel_b.plain(h, csr.src, csr.dst, csr.weight, inv, w0, b0,
                             activate=activate)
        errs.append(max_err(out, ref))
    bound, by = bound_ms(4 * (nn * f + 2 * e + (nn + 1) + nn + f * fo + fo
                              + nn * fo),
                         2 * e_live * f + nn * f + 2 * nn * f * fo + nn * fo)
    kernels.append({
        "name": "fused_gcn_layer", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_layer.cu",
        "replaces": "src/repro/kernels/fused_layer.py:79",
        "launches": launches["fused_gcn_layer"], "max_abs_err": max(errs),
        "ms": time_ms(lambda: kernel_b.launch(
            h, csr.src, csr.row_ptr, csr.weight, inv, w0, b0)),
        "plain_ms": time_ms(lambda: kernel_b.plain(
            h, csr.src, csr.dst, csr.weight, inv, w0, b0)),
        "bound_ms": bound, "bound_by": by, "library_ms": None,
        "shape": {"N": nn, "F": f, "FO": fo, "E": e, "E_live": e_live}})

    buckets = row["inductive_buckets"]
    errs, times = [], {}
    for b in (1, 2, 4, 8, 16, 32, 64):
        nb_emb, nb_mask, _ = batcher.inductive.prepare(unseen[:b], b)
        m = MAX_NEIGHBORS
        src, dst, row_ptr = batcher.inductive.star(b)
        hs = torch.cat([torch.zeros((b, emb_dim), device=dev),
                        nb_emb.reshape(b * m, emb_dim)])
        ws = nb_mask.reshape(-1).contiguous()
        invs = ops.inv_degree(torch.cat([nb_mask.sum(dim=1),
                                         torch.ones(b * m, device=dev)]))
        out = kernel_a.launch(hs, src, row_ptr, ws, invs)
        errs.append(max_err(out, kernel_a.plain(hs, src, dst, ws, b * (1 + m),
                                                invs)))
        sp = torch.sparse_csr_tensor(row_ptr, src, ws * invs[dst.long()],
                                     size=(b * (1 + m), b * (1 + m)),
                                     check_invariants=True)
        times[b] = dict(
            ms=time_ms(lambda: kernel_a.launch(hs, src, row_ptr, ws, invs)),
            plain_ms=time_ms(lambda: kernel_a.plain(hs, src, dst, ws,
                                                    b * (1 + m), invs)),
            library_ms=time_ms(lambda: torch.sparse.mm(sp, hs)),
            live=int((ws > 0).sum()))
        print(f"csr_aggregate bucket {b}: {json.dumps(times[b])}")
    b = max(buckets, key=lambda k: (buckets[k], k)) if buckets else 64
    b = int(b)
    rows, arcs = b * (1 + MAX_NEIGHBORS), b * MAX_NEIGHBORS
    bound, by = bound_ms(
        4 * (rows * emb_dim + 2 * arcs + (rows + 1) + rows + rows * emb_dim),
        2 * times[b]["live"] * emb_dim + rows * emb_dim)
    kernels.append({
        "name": "csr_aggregate", "route": "cuda",
        "source": "src/repro_torch/csrc/csr_aggregate.cu",
        "replaces": "src/repro/kernels/csr_aggregate.py:148",
        "launches": launches["csr_aggregate"], "max_abs_err": max(errs),
        "ms": times[b]["ms"], "plain_ms": times[b]["plain_ms"],
        "bound_ms": bound, "bound_by": by,
        "library_ms": times[b]["library_ms"],
        "shape": {"bucket": b, "N": rows, "F": emb_dim, "E": arcs,
                  "E_live": times[b]["live"]}})

    print(f"total_s={time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
