"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``), their plain
PyTorch versions (``ref``), and the dispatch layer (``ops``)."""
