"""Leiden-Fusion partitioning (numpy), the port's own copy."""
from .assemble import (INTEGRATION_KINDS, PartitionBatch,
                       average_partition_params, build_partition_batch,
                       integrate_models)
from .engine import (CommunityState, QuotientEdges, connected_components,
                     quotient_edges, split_components)
from .fusion import fuse, leiden_fusion
from .graph import Graph, NodeDataset, karate_club, make_arxiv_like
from .leiden import leiden
from .partition import LeidenFusionConfig, partition

__all__ = ["INTEGRATION_KINDS", "PartitionBatch",
           "average_partition_params", "build_partition_batch",
           "integrate_models", "CommunityState",
           "QuotientEdges", "connected_components", "quotient_edges",
           "split_components", "fuse", "leiden_fusion", "Graph",
           "NodeDataset", "karate_club", "make_arxiv_like", "leiden",
           "LeidenFusionConfig", "partition"]
