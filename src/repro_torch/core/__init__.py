"""Partitioning (numpy), the port's own copy: Leiden-Fusion, the paper's
baselines behind the partitioner registry and spec strings, partition
metrics, and the per-partition assembly."""
from .assemble import (INTEGRATION_KINDS, HaloExchangeSpec, PartitionBatch,
                       average_partition_params, build_halo_exchange,
                       build_partition_batch, integrate_models)
from .engine import (CommunityState, QuotientEdges, connected_components,
                     quotient_edges, split_components)
from .fusion import fuse, leiden_fusion
from .graph import (Graph, NodeDataset, karate_club, make_arxiv_like,
                    make_proteins_like)
from .leiden import leiden
from .metrics import PartitionReport, evaluate_partition
from .partitioners import (LeidenFusionConfig, LpaConfig, MetisConfig,
                           RandomConfig, SingleConfig, lpa_partition,
                           metis_partition, random_partition,
                           single_partition, split_into_components,
                           with_fusion)
from .registry import (Capabilities, FusionConfig, NullConfig,
                       RegisteredPartitioner, get_entry,
                       register_partitioner, registered_partitioners,
                       unregister_partitioner)
from .spec import (PartitionResult, PartitionerSpec, parse_spec_text,
                   partition_from_spec)

__all__ = ["INTEGRATION_KINDS", "HaloExchangeSpec", "PartitionBatch",
           "average_partition_params", "build_halo_exchange",
           "build_partition_batch",
           "integrate_models", "CommunityState",
           "QuotientEdges", "connected_components", "quotient_edges",
           "split_components", "fuse", "leiden_fusion", "Graph",
           "NodeDataset", "karate_club", "make_arxiv_like",
           "make_proteins_like", "leiden", "PartitionReport",
           "evaluate_partition", "LeidenFusionConfig", "LpaConfig",
           "MetisConfig", "RandomConfig", "SingleConfig", "lpa_partition",
           "metis_partition", "random_partition", "single_partition",
           "split_into_components", "with_fusion", "Capabilities",
           "FusionConfig", "NullConfig", "RegisteredPartitioner",
           "get_entry", "register_partitioner", "registered_partitioners",
           "unregister_partitioner", "PartitionResult", "PartitionerSpec",
           "parse_spec_text", "partition_from_spec"]
