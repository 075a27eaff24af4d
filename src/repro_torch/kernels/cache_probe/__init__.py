"""Batched LowQuality probe: wrapper, CUDA kernel binding, plain version."""
