"""How the GCN layer's product rounding moves training, on the CPU, and
which products the training parity check accepts.

    PYTHONPATH=src python -m repro_torch.tools.product_rounding

Runs :func:`repro_torch.tools.training_parity.compare_training` on the
configuration of ``chip_smoke.py``'s card-vs-CPU phase (arxiv-like at 2,000
nodes, k = 4, dropout 0, 20 epochs), the plain path against itself with
each layer's ``agg @ W`` swapped for a variant:

* legitimate roundings of the same function: f64 rounded once to f32
  (more accurate), f32 summed in 32-wide k-chunks in reverse order, and
  3xTF32 (each operand split into a TF32 high part and the rest, the
  low-times-low term dropped);
* wrong functions: W scaled by 1 + 1e-5 and by 1 + 1e-3.

It prints each variant's errors and ratios to the tolerances (above 1 the
check fails). Runs in about three minutes on the CPU.

The plain path's layer product is ``fused_layer.gcn_epilogue``;
:func:`swapped_product` swaps it and puts it back.
"""
import contextlib
import json

import torch

from repro_torch.kernels import fused_layer
from repro_torch.kernels.ref import gcn_epilogue
from repro_torch.pipeline.pipeline import PipelineConfig, run_training

from .training_parity import compare_training

PHASE6_CONFIG = PipelineConfig(dataset="arxiv-like", k=4, dropout=0.0,
                               epochs=20, classifier_epochs=0,
                               dataset_kwargs={"n": 2000})


def f64_product(agg, w, b, activate):
    z = (agg.double() @ w.double() + b.double()[None, :]).float()
    return torch.relu(z) if activate else z


def reversed_chunk_product(agg, w, b, activate, chunk=32):
    """The f32 product summed over 32-wide k-chunks, last chunk first."""
    w = w.float()
    z = torch.zeros((agg.shape[0], w.shape[1]), dtype=torch.float32)
    for k0 in reversed(range(0, agg.shape[1], chunk)):
        z = z + agg[:, k0:k0 + chunk] @ w[k0:k0 + chunk]
    z = z + b.float()[None, :]
    return torch.relu(z) if activate else z


def tf32_parts(x):
    """x = hi + lo: hi rounded to TF32 (to nearest), lo the rest as the
    tensor core reads it (truncated to TF32)."""
    bits = x.float().contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    lo = ((x.float() - hi).contiguous().view(torch.int32)
          & ~0x1FFF).view(torch.float32)
    return hi.double(), lo.double()


def tf32x3_product(agg, w, b, activate):
    ah, al = tf32_parts(agg)
    wh, wl = tf32_parts(w)
    z = (ah @ wh + al @ wh + ah @ wl).float() + b.float()[None, :]
    return torch.relu(z) if activate else z


def scaled_w_product(scale):
    """A wrong product: W scaled by ``scale``."""
    def product(agg, w, b, activate):
        return gcn_epilogue(agg, w * scale, b, activate)
    return product


LEGITIMATE = {"f64": f64_product, "reversed_chunks": reversed_chunk_product,
              "3xtf32": tf32x3_product}
WRONG = {"w_1e-5": scaled_w_product(1 + 1e-5),
         "w_1e-3": scaled_w_product(1 + 1e-3)}


@contextlib.contextmanager
def swapped_product(product):
    """Run the plain path's layer product as ``product`` inside."""
    fused_layer.gcn_epilogue = product
    try:
        yield
    finally:
        fused_layer.gcn_epilogue = gcn_epilogue


def compare_product(product, cfg=PHASE6_CONFIG, reference=None,
                    loss_epochs=None):
    """The parity check's row for the plain path with ``product`` against
    ``reference`` (``cfg -> PipelineResult``; default: the plain path as
    it is)."""
    def run(c):
        with swapped_product(product):
            return run_training(c, device="cpu")
    return compare_training(
        cfg, run, reference or (lambda c: run_training(c, device="cpu")),
        loss_epochs)


def main():
    for name, product in {**LEGITIMATE, **WRONG}.items():
        print(f"{name}: {json.dumps(compare_product(product))}", flush=True)


if __name__ == "__main__":
    main()
