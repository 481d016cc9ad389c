"""How far the GCN layer's product rounding moves training, on the CPU.

    PYTHONPATH=src python -m repro_torch.tools.product_rounding

Trains the configuration of ``chip_smoke.py``'s card-vs-CPU gate
(arxiv-like at 2,000 nodes, k = 4, dropout 0, 20 epochs) with the port's
plain path three times: as it is (f32 products, k in order), with each
layer's ``agg @ W`` computed in f64 and rounded once to f32 (more accurate),
and with it computed as 3xTF32 would (each operand split into a TF32 high
part and the rest, the low-times-low term dropped). It prints how far each
variant's per-epoch losses and pooled table land from the first run, and
the table's worst ratio to the gate's tolerance (1e-3 abs + rel): above 1
the gate fails. Runs in about a minute on the CPU.

The plain path's layer product is ``fused_layer.gcn_epilogue``; the script
swaps it for each variant in turn and puts it back.
"""
import numpy as np
import torch

from repro_torch.kernels import fused_layer
from repro_torch.kernels.ref import gcn_epilogue
from repro_torch.pipeline.pipeline import PipelineConfig, run_training

TABLE_TOL = 1e-3


def f64_product(agg, w, b, activate):
    z = (agg.double() @ w.double() + b.double()[None, :]).float()
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


def main():
    cfg = PipelineConfig(dataset="arxiv-like", k=4, dropout=0.0, epochs=20,
                         classifier_epochs=0, dataset_kwargs={"n": 2000})
    base = run_training(cfg, device="cpu")
    for name, product in (("f64 product", f64_product),
                          ("3xTF32 product", tf32x3_product)):
        fused_layer.gcn_epilogue = product
        try:
            run = run_training(cfg, device="cpu")
        finally:
            fused_layer.gcn_epilogue = gcn_epilogue
        diff = (run.embeddings - base.embeddings).abs()
        ratio = diff / (TABLE_TOL + TABLE_TOL * base.embeddings.abs())
        print(f"{name}: max loss diff "
              f"{np.abs(run.losses - base.losses).max():.3e}, max table "
              f"diff {float(diff.max()):.4e}, worst ratio to the gate's "
              f"tolerance {float(ratio.max()):.2f}")


if __name__ == "__main__":
    main()
