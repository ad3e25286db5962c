"""Measurement scripts of the port, run by path on a CUDA machine."""
