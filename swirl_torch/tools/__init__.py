"""Measurement tools for the port's CUDA kernels (run on a machine with the card)."""
