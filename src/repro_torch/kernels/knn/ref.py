"""Plain PyTorch version of the fused kNN search (``csrc/knn.cu``).

One masked (B, N) score matrix and a stable descending sort, so equal
scores keep the lower corpus position (``lax.top_k``'s order); -inf
results carry id -1 and k > N pads with (-inf, -1).  ``score`` is the
plain version of the score kernel alone, ``search`` of the whole op.
"""

from __future__ import annotations

import torch


def score(docs: torch.Tensor, doc_ids: torch.Tensor, queries: torch.Tensor,
          scale: torch.Tensor | None = None,
          q_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Masked (B, N) f32 scores.  With ``q_scale`` the queries are an int8
    payload and the dot is the exact integer sum (taken in f64, exact for
    any practical width), scaled as (f32(acc) * q_scale) * scale."""
    if q_scale is not None:
        acc = queries.to(torch.float64) @ docs.to(torch.float64).T
        scores = acc.to(torch.float32) * q_scale[:, None]
    else:
        scores = queries.to(torch.float32) @ docs.to(torch.float32).T
    if scale is not None:
        scores = scores * scale[None, :]
    return torch.where(doc_ids[None, :] < 0,
                       torch.tensor(float("-inf"), device=scores.device), scores)


def select(scores: torch.Tensor, doc_ids: torch.Tensor, k: int):
    """Stable top-k of (B, N) scores -> (vals (B, k), ids (B, k))."""
    ids = doc_ids
    if k > scores.shape[1]:
        pad = k - scores.shape[1]
        scores = torch.nn.functional.pad(scores, (0, pad), value=float("-inf"))
        ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
    top_s, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    top_s, pos = top_s[:, :k], pos[:, :k]
    top_i = torch.where(torch.isneginf(top_s),
                        torch.tensor(-1, dtype=ids.dtype, device=ids.device),
                        ids[pos])
    return top_s, top_i


def search(docs, doc_ids, queries, k, scale=None, q_scale=None):
    return select(score(docs, doc_ids, queries, scale, q_scale), doc_ids, k)
