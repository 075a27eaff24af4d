"""EmbeddingBag: wrapper, CUDA kernel binding, plain version."""
