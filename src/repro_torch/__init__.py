"""PyTorch/CUDA port of the Leiden-Fusion pipeline, for an NVIDIA H100.

The JAX package ``repro`` is the reference this package is held against;
nothing here imports it or JAX. It runs three paths, on hand-written CUDA
kernels on the card and their plain PyTorch versions on the CPU:

* GCN serving: dataset -> Leiden-Fusion partition -> per-partition
  assembly -> GCN forward per partition (kernel B) -> pooled embedding
  table -> classifier -> serving bundle -> EmbeddingStore -> continuous
  batcher with inductive fallback (kernel A);
* GCN local training: k replicas trained independently through the
  kernels' autograd Functions (kernel B forward; kernel A over the
  reversed arcs and kernel C backward), AdamW, classifier;
* dense-LM serving: bucketed prefill -> lock-step decode over an in-place
  KV cache, decode attention on kernel D.

Layout mirrors the reference: ``core`` (numpy partitioning), ``kernels``
(CUDA kernels in ``csrc`` with their plain PyTorch versions), ``gnn``,
``optim``, ``pipeline``, ``serving``, ``models`` and ``configs`` (the LM),
``launch`` (the LM serving loop).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
