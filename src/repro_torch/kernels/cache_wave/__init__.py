"""Fused wave ops over the stacked caches: wrapper, CUDA binding, plain version."""
