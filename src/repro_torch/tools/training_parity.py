"""The training parity check: one run of the training pipeline against
another from the same initial parameters (the card against the CPU path).

Two runs that differ only in rounding drift apart through every AdamW step,
so a table check after many epochs cannot tell rounding from error: after
20 epochs it failed an f64-exact layer product (80.8x the tolerance) and
an f32 product summed in reversed 32-wide chunks (75.7x), both correct.
This check holds

* the per-epoch losses of a run of ``cfg.epochs`` epochs within
  ``LOSS_TOL`` (abs + rel): rounding stays well inside it, a gross error
  (W scaled by 1 + 1e-3) misses it at the first epoch;
* the pooled table after ``TABLE_EPOCHS`` epochs within ``TABLE_TOL`` (abs
  + rel): rounding has not compounded yet, while a small systematic error
  (W scaled by 1 + 1e-5) already fails it.

The table after ``cfg.epochs`` is reported, not held. A caller may hold
the losses over the first ``loss_epochs`` epochs only, where the losses
of a configuration leave the tolerance under legitimate rounding later in
the run: GraphSAGE on arxiv-like at 2,000 nodes does at epochs 6-7 (2.0-
2.9x, the loss falling from 3.6 to 0.5), with an f64 or a reversed-chunk
product on the CPU as on the card. The rest is reported.
``tests/test_torch_training_parity.py`` pins both sides on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np

LOSS_TOL = 1e-4
TABLE_TOL = 1e-3
TABLE_EPOCHS = 2

__all__ = ["LOSS_TOL", "TABLE_TOL", "TABLE_EPOCHS", "tolerance_ratio",
           "compare_training"]


def tolerance_ratio(got: np.ndarray, ref: np.ndarray, tol: float) -> float:
    """max |got - ref| / (tol + tol·|ref|): at most 1 where
    ``np.allclose(got, ref, rtol=tol, atol=tol)`` holds."""
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if not (np.isfinite(got).all() and np.isfinite(ref).all()):
        return float("inf")
    return float((np.abs(got - ref) / (tol + tol * np.abs(ref))).max())


def _table(result) -> np.ndarray:
    return result.embeddings.detach().cpu().numpy()


def compare_training(cfg, run: Callable, reference: Callable,
                     loss_epochs: Optional[int] = None) -> Dict[str, Any]:
    """Train ``cfg`` with ``run`` and ``reference`` (each ``cfg ->``
    :class:`~repro_torch.pipeline.pipeline.PipelineResult`, from the same
    seeded initial parameters) for ``cfg.epochs`` and for
    ``TABLE_EPOCHS`` epochs. Returns the errors, their ratios to the
    tolerances, and ``ok``: the losses of the first ``loss_epochs`` epochs
    (all by default) and the short run's table hold."""
    full = (run(cfg), reference(cfg))
    short_cfg = dataclasses.replace(cfg, epochs=TABLE_EPOCHS)
    short = (run(short_cfg), reference(short_cfg))
    losses = [r.losses for r in full]
    held = [x[:loss_epochs] for x in losses]
    tables = [_table(r) for r in short]
    tables_full = [_table(r) for r in full]
    row = {
        "epochs": cfg.epochs,
        "loss_epochs": len(held[0]),
        "loss_err": float(np.abs(held[0] - held[1]).max()),
        "loss_ratio": tolerance_ratio(held[0], held[1], LOSS_TOL),
        "loss_ratio_by_epoch": [tolerance_ratio(a, b, LOSS_TOL)
                                for a, b in zip(*losses)],
        "table_epochs": TABLE_EPOCHS,
        "table_err": float(np.abs(tables[0] - tables[1]).max()),
        "table_ratio": tolerance_ratio(tables[0], tables[1], TABLE_TOL),
        "table_err_full": float(np.abs(tables_full[0]
                                       - tables_full[1]).max()),
        "table_ratio_full": tolerance_ratio(tables_full[0], tables_full[1],
                                            TABLE_TOL),
        "loss_first": float(losses[1][0].mean()),
        "loss_last": float(losses[1][-1].mean()),
    }
    row["ok"] = row["loss_ratio"] <= 1.0 and row["table_ratio"] <= 1.0
    return row
