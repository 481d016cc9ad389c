"""PyTorch/CUDA port of the Leiden-Fusion pipeline, for an NVIDIA H100.

The JAX package ``repro`` is the reference this package is held against;
nothing here imports it or JAX. This slice runs the serving path:

    dataset -> Leiden-Fusion partition -> per-partition assembly
    -> GCN forward per partition (hand-written CUDA kernels)
    -> pooled embedding table -> classifier -> serving bundle
    -> EmbeddingStore -> continuous batcher with inductive fallback

Layout mirrors the reference: ``core`` (numpy partitioning), ``kernels``
(CUDA kernels in ``csrc`` with their plain PyTorch versions), ``gnn``,
``pipeline``, ``serving``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
