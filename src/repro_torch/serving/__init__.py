"""Partition-sharded embedding serving: bundle export and load, an LRU
hot-node cache, a continuous batcher, and an inductive fallback that
averages a new node's neighbours through the aggregation kernel.

Entry point: ``python -m repro_torch.serving`` (export, replay, verify).
"""
