"""Measurement scripts for the port's kernels (run on a card or the CPU,
never imported by the pipeline)."""
