"""Plain PyTorch version of the embedding-bag kernel (``csrc/embedding_bag.cu``).

The CPU path and the tests use it; ``chip_smoke.py`` holds the kernel
against it on the card.  It computes what the JAX package's Pallas path
computes (``repro/kernels/embedding_bag/embedding_bag.py`` with the wrapper
arithmetic of its ``ops.py``), which differs from that package's jnp
reference in max mode: an item counts toward the max only where its
weight is > 0, so a bag whose weights are all 0 answers 0 (the jnp
reference takes the max over every valid item whatever its weight).
"""

from __future__ import annotations

import torch


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  weights: torch.Tensor | None = None,
                  mode: str = "sum") -> torch.Tensor:
    """table (V, D) f32 / f16 / bf16; indices (B, L) int, < 0 padding, >= V
    read as row V - 1; weights (B, L) or None (ones) -> (B, D) f32."""
    v = table.shape[0]
    valid = indices >= 0
    safe = torch.where(valid, indices, 0).clamp(max=v - 1).long()
    rows = table[safe].to(torch.float32)                         # (B, L, D)
    w = (torch.ones(indices.shape, dtype=torch.float32, device=table.device)
         if weights is None else weights.to(torch.float32))
    w = torch.where(valid, w, 0.0)
    if mode == "max":
        neg = torch.tensor(float("-inf"), device=table.device)
        out = torch.where((w > 0)[..., None], rows, neg).amax(dim=1) \
            if indices.shape[1] else rows.new_full(
                (indices.shape[0], table.shape[1]), float("-inf"))
        return torch.where(torch.isfinite(out), out, 0.0)
    out = torch.where(valid[..., None], w[..., None] * rows, 0.0).sum(dim=1)
    if mode == "mean":
        out = out / valid.sum(dim=1, keepdim=True).clamp(min=1)
    return out
