"""Measurement harnesses of the port's kernels (ports of ``experiments/``)."""
