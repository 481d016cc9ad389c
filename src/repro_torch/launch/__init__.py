"""Launchers: ``python -m repro_torch.launch.train`` (GNN and LM
training), ``python -m repro_torch.launch.serve`` (LM serving)."""
