"""Fused kNN search: wrapper, CUDA kernel binding, plain version."""
