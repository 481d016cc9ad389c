"""Kernels B (``need_agg``, the training forward) and A over the reversed
arcs (the backward's ``dh``) of this tree and of another checkout, timed in
turns on the main path's partitions, in one process on one card.

    PYTHONPATH=src python -m repro_torch.tools.kernel_turns --other ROOT

``ROOT`` is the root of another checkout of the repository (for example a
``git archive`` of the parent commit). Its ``repro_torch`` package is
loaded under another name and its kernels are built from its own sources
into its own build directory; both trees' kernels are called through
their Python wrappers (``fused_layer.launch``, ``csr_aggregate.launch``),
so the two C interfaces may differ. The partitions are those of
``chip_smoke.py``'s main path (arxiv-like at 169,343 nodes, Leiden-Fusion
k = 8, repli assembly), whose weight-0 padding arcs sit in one row each;
the weights are the seeded layer-0 ones. For each partition it prints one
JSON line: both trees' times (CUDA events, median of 10 calls, in the
order other, this, this, other, each tree's figure the mean of its two
turns) and both trees' max abs error against the plain version. Every
output must match the plain version at 3e-5 (abs + rel; "rel" against the
sum of absolute terms), or the script exits non-zero. The last line is
the card's name and power limit as ``nvidia-smi`` prints them.
"""
import argparse
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys

import torch

from repro_torch.kernels import csr_aggregate, fused_layer, ops
from repro_torch.kernels import ref as plain
from repro_torch.pipeline.pipeline import PipelineConfig, run_inference

TOL = 3e-5
ITERS = 10


def load_other(root: str, name: str = "other_repro_torch"):
    """(fused_layer, csr_aggregate) kernel modules of the checkout at
    ``root``, imported as package ``name``."""
    pkg = os.path.join(os.path.abspath(root), "src", "repro_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module(f"{name}.kernels.fused_layer"),
            importlib.import_module(f"{name}.kernels.csr_aggregate"))


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


def max_err(out, ref, scale, what) -> float:
    diff = (out - ref).abs()
    if not (torch.isfinite(out).all() and (diff <= TOL + TOL * scale).all()):
        raise SystemExit(f"{what} disagrees with its plain version: max abs "
                         f"err {float(diff.max())}")
    return float(diff.max())


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
    other_b, other_a = load_other(args.other)
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
        row = {"p": q, "pad_arcs": int((c.weight == 0).sum()),
               "row_max": int(c.row_ptr.diff().max()),
               "rev_row_max": int(c.rev_row_ptr.diff().max())}
        for tree, kb, ka in (("this", fused_layer, csr_aggregate),
                             ("other", other_b, other_a)):
            out, agg = kb.launch(h, c.src, c.row_ptr, c.weight, inv, w0, b0,
                                 activate=False, need_agg=True)
            row[f"{tree}_fused_err"] = max(
                max_err(out, out_ref, out_abs, f"{tree} kernel B ({q})"),
                max_err(agg, agg_ref, agg_abs, f"{tree} kernel B agg ({q})"))
            row[f"{tree}_transpose_err"] = max_err(
                ka.launch(g, c.rev_src, c.rev_row_ptr, rev_w), dh_ref, dh_abs,
                f"{tree} kernel A transposed ({q})")
        for key, call in (
                ("fused", lambda kb, ka: kb.launch(
                    h, c.src, c.row_ptr, c.weight, inv, w0, b0,
                    need_agg=True)),
                ("transpose", lambda kb, ka: ka.launch(
                    g, c.rev_src, c.rev_row_ptr, rev_w))):
            mine = lambda: call(fused_layer, csr_aggregate)       # noqa: E731
            theirs = lambda: call(other_b, other_a)               # noqa: E731
            t = [time_ms(fn) for fn in (theirs, mine, mine, theirs)]
            row[f"this_{key}_ms"] = (t[1] + t[2]) / 2
            row[f"other_{key}_ms"] = (t[0] + t[3]) / 2
            row[f"{key}_turns_ms"] = t
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for key in ("fused", "transpose"):
        for tree in ("this", "other"):
            times = [r[f"{tree}_{key}_ms"] for r in rows]
            summary[f"{tree}_{key}"] = {
                "mean_ms": statistics.mean(times), "min_ms": min(times),
                "max_ms": max(times),
                "worst_over_best": max(times) / min(times)}
    print(json.dumps({"summary": summary}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
