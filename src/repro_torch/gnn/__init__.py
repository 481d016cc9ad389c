"""GCN / GraphSAGE inference on the partition subgraphs."""
