"""Disabled-mode cost of :mod:`repro_torch.obs`, projected and gated.

With tracing off (the default), an instrumented call site costs one
function call and one attribute check, and an always-on metric one locked
update; together they must stay under 1% of the pipeline's wall time. The
tool measures both unit costs in a tight loop, multiplies them by what a
traced run of the port's pipeline counts (its spans, and its metric
mutations from ``MetricsRegistry.total_ops``), and holds the projection
against 1% of an untraced run's wall time. A projection, because the
difference of two walls of a host-bound pipeline is noisier than the
effect it would measure. The counterpart of the reference's
``tools/obs_overhead_smoke.py``, on the port's pipeline.

    PYTHONPATH=src python -m repro_torch.tools.obs_overhead            # card
    PYTHONPATH=src python -m repro_torch.tools.obs_overhead --device cpu
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional, Tuple

from repro_torch import obs
from repro_torch.device import DeviceLike

__all__ = ["CALIBRATION_OPS", "OVERHEAD_BUDGET", "per_op_costs",
           "run_pipeline", "measure", "main"]

CALIBRATION_OPS = 200_000
OVERHEAD_BUDGET = 0.01      # 1% of the untraced pipeline's wall


def per_op_costs() -> Tuple[float, float]:
    """Measured seconds per disabled span call and per metric mutation."""
    obs.reset()     # disabled mode
    t0 = time.perf_counter()
    for _ in range(CALIBRATION_OPS):
        with obs.span("calib.noop", x=1):
            pass
    span_cost = (time.perf_counter() - t0) / CALIBRATION_OPS

    ctr = obs.counter("calib.ops")
    t0 = time.perf_counter()
    for _ in range(CALIBRATION_OPS):
        ctr.inc()
    metric_cost = (time.perf_counter() - t0) / CALIBRATION_OPS
    obs.reset()
    return span_cost, metric_cost


def run_pipeline(traced: bool, device: DeviceLike) -> Tuple[float, int, int]:
    """One small karate training pipeline on ``device``; returns (wall
    seconds, spans recorded, metric mutations)."""
    from repro_torch.pipeline.pipeline import PipelineConfig, run_training
    obs.reset()
    if traced:
        obs.enable()
    cfg = PipelineConfig(dataset="karate", method="leiden_fusion", k=2,
                         mode="local", epochs=3, classifier_epochs=10)
    t0 = time.perf_counter()
    run_training(cfg, device=device)
    wall = time.perf_counter() - t0
    spans = obs.tracer().event_count()
    ops = obs.registry().total_ops()
    obs.reset()
    return wall, spans, ops


def measure(device: DeviceLike = "cuda") -> Dict[str, float]:
    """Unit costs, a traced run's counts (run first: it also warms the
    kernels), an untraced run's wall, and the projected share."""
    span_cost, metric_cost = per_op_costs()
    _, spans, traced_ops = run_pipeline(True, device)
    wall, untraced_spans, untraced_ops = run_pipeline(False, device)
    if untraced_spans:
        raise AssertionError(f"disabled mode recorded {untraced_spans} "
                             f"spans")
    projected = spans * span_cost + traced_ops * metric_cost
    return {"span_ns": span_cost * 1e9, "metric_op_ns": metric_cost * 1e9,
            "spans": spans, "traced_metric_ops": traced_ops,
            "untraced_metric_ops": untraced_ops, "wall_s": wall,
            "projected_ms": projected * 1e3, "share": projected / wall}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tools.obs_overhead",
        description="project the disabled-mode cost of repro_torch.obs "
                    "onto the port's pipeline and gate it at 1% of wall")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    m = measure(args.device)
    print(f"calibration: {m['span_ns']:.0f} ns/disabled-span, "
          f"{m['metric_op_ns']:.0f} ns/metric-op ({CALIBRATION_OPS} ops "
          f"each)")
    print(f"pipeline on {args.device}: wall={m['wall_s']:.3f}s untraced "
          f"({m['spans']} span sites, {m['traced_metric_ops']} metric ops "
          f"traced, {m['untraced_metric_ops']} untraced)")
    print(f"projected disabled-mode overhead: {m['projected_ms']:.4f} ms = "
          f"{m['share'] * 100:.5f}% of wall (budget {OVERHEAD_BUDGET:.0%})")
    if m["share"] >= OVERHEAD_BUDGET:
        print("FAIL: disabled-mode obs overhead exceeds the 1% budget",
              file=sys.stderr)
        return 1
    print("OK: disabled-mode obs overhead within the 1% budget")
    return 0


if __name__ == "__main__":
    sys.exit(main())
