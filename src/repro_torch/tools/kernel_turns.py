"""The kernels of this tree and of another checkout, timed in turns in one
process on one card: kernels B (``need_agg``, the training forward), A
over the reversed arcs (the backward's ``dh``) and C (the arc-weight
gradient) on each of the main path's partitions, and kernel D at
``chip_smoke.py`` phase 11's shapes.

    PYTHONPATH=src python -m repro_torch.tools.kernel_turns --other ROOT

``ROOT`` is the root of another checkout of the repository (for example a
``git archive`` of the parent commit). Its ``repro_torch`` package is
loaded under another name and its kernels are built from its own sources
into its own build directory; both trees' kernels are called through
their Python wrappers (``fused_layer.launch``, ``csr_aggregate.launch``,
``edge_dot.launch``, ``flash_decode.launch``), so the two C interfaces
may differ. The partitions are those of ``chip_smoke.py``'s main path
(arxiv-like at 169,343 nodes, Leiden-Fusion k = 8, repli assembly), whose
weight-0 padding arcs sit in one row each; the weights are the seeded
layer-0 ones. Kernel D's shapes: the serving run's largest bucket (B 3,
cache 1,056, the rows' first-step lengths), decode_32k's layer (B 128, S
32,768, H 32, Hkv 8, D 128) in bf16 and at B 16 in f32, and long_500k's
ring (B 1, S 8,192), on seeded inputs. For each partition and each D
shape it prints one JSON line: both trees' times (CUDA events, median of
10 calls, in the order other, this, this, other, each tree's figure the
mean of its two turns), both trees' device time per call and device
launches per call (``torch.profiler``), for kernel D also the wrapper's
host microseconds per call (500 calls issued back to back, in the same
turns; where the kernel outlasts the host work, the queue fills and this
is device time), and both trees' max abs error against the plain
version. Every output must match the plain version (3e-5 abs + rel,
"rel" against the sum of absolute terms; kernel D in bf16 at 2e-2 abs +
rel), or the script exits non-zero. The last line is the card's name and
power limit as ``nvidia-smi`` prints them.
"""
import argparse
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import torch

from repro_torch.kernels import (csr_aggregate, edge_dot, flash_decode,
                                 fused_layer, ops)
from repro_torch.kernels import ref as plain
from repro_torch.pipeline.pipeline import PipelineConfig, run_inference

TOL = 3e-5
BF16_TOL = 2e-2
ITERS = 10
KERNELS = ("fused_layer", "csr_aggregate", "edge_dot", "flash_decode")


def load_other(root: str, name: str = "other_repro_torch"):
    """The kernel modules named in ``KERNELS`` of the checkout at ``root``,
    imported as package ``name``."""
    pkg = os.path.join(os.path.abspath(root), "src", "repro_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return tuple(importlib.import_module(f"{name}.kernels.{k}")
                 for k in KERNELS)


def time_ms(fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(ITERS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_us(fn, names: tuple, calls: int = 20):
    """(device us per launch, launches per call) of the kernels whose name
    holds one of ``names``, over ``calls`` calls under ``torch.profiler``
    (CUPTI). A window on the card has lost records (its first, sometimes
    more; once all of them), so a window whose count is not a whole
    number of launches a call is taken again (three tries) and the
    launches a call are a lower bound."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and any(n in e.name for n in names)]
        if len(evs) % calls == 0 and evs:
            break
    return (sum(e.time_range.elapsed_us() for e in evs)
            / max(len(evs), 1), len(evs) / calls)


def turns(row: dict, key: str, mine, theirs, names: tuple) -> None:
    """Both trees' CUDA-event times in turns and device times into
    ``row``."""
    t = [time_ms(fn) for fn in (theirs, mine, mine, theirs)]
    row[f"this_{key}_ms"] = (t[1] + t[2]) / 2
    row[f"other_{key}_ms"] = (t[0] + t[3]) / 2
    row[f"{key}_turns_ms"] = t
    for tree, fn in (("this", mine), ("other", theirs)):
        us, n = device_us(fn, names)
        row[f"{tree}_{key}_device_ms"] = us * round(n) / 1e3
        row[f"{tree}_{key}_device_launches"] = n


def host_us(fn, calls: int = 500) -> float:
    """Host microseconds per call of ``fn`` issued back to back (the
    device runs behind; one synchronize at the end, outside the clock)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def max_err(out, ref, scale, what) -> float:
    diff = (out - ref).abs()
    if not (torch.isfinite(out).all() and (diff <= TOL + TOL * scale).all()):
        raise SystemExit(f"{what} disagrees with its plain version: max abs "
                         f"err {float(diff.max())}")
    return float(diff.max())


def kernel_d_turns(dev, other_d):
    """Kernel D of both trees at phase 11's shapes, in turns."""
    import numpy as np
    gen = torch.Generator(device=dev).manual_seed(3)
    h, hkv, d = 32, 8, 128
    filled = np.random.default_rng(3).integers(1, 32769, 128)
    filled[:5] = (1, 511, 512, 513, 32768)
    cases = (("serving", 3, 1056, torch.bfloat16, [882, 677, 556]),
             ("decode_32k", 128, 32768, torch.bfloat16, filled),
             ("decode_32k_f32", 16, 32768, torch.float32, filled[:16]),
             ("long_500k_ring", 1, 8192, torch.bfloat16, [8192]))
    rows = []
    for case, b, s, dtype, lengths in cases:
        q = torch.randn((b, h, d), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, s, hkv, d), generator=gen, device=dev,
                        dtype=dtype)
        v = torch.randn((b, s, hkv, d), generator=gen, device=dev,
                        dtype=dtype)
        f = torch.as_tensor(np.asarray(lengths), dtype=torch.int32,
                            device=dev)
        ref = torch.cat([plain.flash_decode_ref(q[i:i + 8], k[i:i + 8],
                                                v[i:i + 8], f[i:i + 8])
                         for i in range(0, b, 8)]).float()
        scale = torch.cat([plain.flash_decode_ref(
            q[i:i + 8], k[i:i + 8], v[i:i + 8].abs(), f[i:i + 8])
            for i in range(0, b, 8)]).float()
        row = {"case": case, "B": b, "S": s,
               "dtype": str(dtype).split(".")[-1]}
        for tree, kd in (("this", flash_decode), ("other", other_d)):
            out = kd.launch(q, k, v, f).float()
            if dtype == torch.float32:
                row[f"{tree}_err"] = max_err(out, ref, scale,
                                             f"{tree} kernel D {case}")
            else:
                diff = (out - ref).abs()
                if not (torch.isfinite(out).all() and (
                        diff <= BF16_TOL + BF16_TOL * ref.abs()).all()):
                    raise SystemExit(f"{tree} kernel D {case} disagrees "
                                     f"with its plain version")
                row[f"{tree}_err"] = float(diff.max())
        turns(row, "", lambda: flash_decode.launch(q, k, v, f),
              lambda: other_d.launch(q, k, v, f), ("flash_decode",))
        for tree, kd in (("this", flash_decode), ("other", other_d),
                         ("this", flash_decode), ("other", other_d)):
            row.setdefault(f"{tree}_host_us", []).append(
                host_us(lambda: kd.launch(q, k, v, f)))
        row = {k.replace("__", "_").strip("_"): x for k, x in row.items()}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del q, k, v, ref, scale
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", required=True, metavar="ROOT",
                        help="root of the other checkout")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_turns: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    other_b, other_a, other_c, other_d = load_other(args.other)
    cfg = PipelineConfig(dataset="arxiv-like", k=8, scheme="repli",
                         dataset_kwargs={"scale": 169343 / 40000})
    result = run_inference(cfg, device=dev)
    tens, layer0 = result.tensors, result.params["body"]["layers"][0]
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for q in range(tens.k):
        c = tens.csrs[q]
        h = tens.features[q].contiguous()
        inv = ops.inv_degree(tens.in_degree[q])
        w0, b0 = layer0["w"][q].contiguous(), layer0["b"][q].contiguous()
        nn = h.shape[0]
        g = torch.randn(h.shape, generator=gen, device=dev)
        rev_w = (c.weight * inv[c.dst.long()])[c.rev_perm].contiguous()
        rev_dst = c.src[c.rev_perm].contiguous()
        agg_ref = plain.csr_aggregate_ref(h, c.src, c.dst, c.weight, nn, inv)
        agg_abs = plain.csr_aggregate_ref(h.abs(), c.src, c.dst, c.weight,
                                          nn, inv)
        out_ref = plain.gcn_epilogue(agg_ref, w0, b0, False)
        out_abs = plain.gcn_epilogue(agg_abs, w0.abs(), b0.abs(), False)
        dh_ref = plain.csr_aggregate_ref(g, c.rev_src, rev_dst, rev_w, nn)
        dh_abs = plain.csr_aggregate_ref(g.abs(), c.rev_src, rev_dst, rev_w,
                                         nn)
        dw_ref = plain.edge_dot_ref(h, g, c.src, c.dst, inv)
        dw_abs = plain.edge_dot_ref(h.abs(), g.abs(), c.src, c.dst, inv)
        row = {"p": q, "pad_arcs": int((c.weight == 0).sum()),
               "row_max": int(c.row_ptr.diff().max()),
               "rev_row_max": int(c.rev_row_ptr.diff().max())}
        for tree, kb, ka, kc in (("this", fused_layer, csr_aggregate,
                                  edge_dot),
                                 ("other", other_b, other_a, other_c)):
            out, agg = kb.launch(h, c.src, c.row_ptr, c.weight, inv, w0, b0,
                                 activate=False, need_agg=True)
            row[f"{tree}_fused_err"] = max(
                max_err(out, out_ref, out_abs, f"{tree} kernel B ({q})"),
                max_err(agg, agg_ref, agg_abs, f"{tree} kernel B agg ({q})"))
            row[f"{tree}_transpose_err"] = max_err(
                ka.launch(g, c.rev_src, c.rev_row_ptr, rev_w), dh_ref, dh_abs,
                f"{tree} kernel A transposed ({q})")
            row[f"{tree}_edge_dot_err"] = max_err(
                kc.launch(h, g, c.src, c.dst, inv), dw_ref, dw_abs,
                f"{tree} kernel C ({q})")
        for key, names, call in (
                ("fused", ("csr_aggregate", "fused_gcn"),
                 lambda kb, ka, kc: kb.launch(
                     h, c.src, c.row_ptr, c.weight, inv, w0, b0,
                     need_agg=True)),
                ("transpose", ("csr_aggregate",), lambda kb, ka, kc:
                 ka.launch(g, c.rev_src, c.rev_row_ptr, rev_w)),
                ("edge_dot", ("edge_dot",), lambda kb, ka, kc: kc.launch(
                    h, g, c.src, c.dst, inv))):
            turns(row, key,
                  lambda: call(fused_layer, csr_aggregate, edge_dot),
                  lambda: call(other_b, other_a, other_c), names)
        rows.append(row)
        print(json.dumps(row), flush=True)
    del result, tens
    torch.cuda.empty_cache()
    d_rows = kernel_d_turns(dev, other_d)
    summary = {}
    for key in ("fused", "transpose", "edge_dot"):
        for tree in ("this", "other"):
            times = [r[f"{tree}_{key}_ms"] for r in rows]
            summary[f"{tree}_{key}"] = {
                "mean_ms": statistics.mean(times), "min_ms": min(times),
                "max_ms": max(times),
                "worst_over_best": max(times) / min(times)}
    print(json.dumps({"summary": summary, "kernel_d": {
        r["case"]: {k: r[k] for k in (
            "this_ms", "other_ms", "this_device_ms", "other_device_ms",
            "this_device_launches", "other_device_launches", "this_host_us",
            "other_host_us")}
        for r in d_rows}}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
