"""Kernel layer of the port: hand-written CUDA kernels and their wrappers."""
