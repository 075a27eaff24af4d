"""Exact top-k by inner product over the corpus, drawn again block by block
from the seed (so the reference holds no second copy of it)."""

from __future__ import annotations

import torch

from chipbench.reference import eq1, mm


def corpus_topk(recipe, queries: torch.Tensor, k: int,
                precision: str = "f32", query_rows: int = 512):
    """(scores (B, k) descending, ids (B, k) int64) of ``queries`` (B, D+1)
    over the Eq. 1-transformed corpus of ``recipe``."""
    norms = recipe.norms()
    m = float(norms.max())
    b = queries.shape[0]
    best_s = queries.new_full((b, k), float("-inf"))
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=queries.device)
    for lo, hi, raw in recipe.blocks(norms):
        docs = eq1.documents(raw, m)
        del raw
        for q0 in range(0, b, query_rows):
            q1 = min(q0 + query_rows, b)
            s = mm(queries[q0:q1], docs.T, precision)
            top_s, top_i = torch.topk(s, min(k, hi - lo), dim=1)
            cat_s = torch.cat([best_s[q0:q1], top_s], dim=1)
            cat_i = torch.cat([best_i[q0:q1], top_i + lo], dim=1)
            keep_s, pos = torch.topk(cat_s, k, dim=1)
            best_s[q0:q1] = keep_s
            best_i[q0:q1] = torch.gather(cat_i, 1, pos)
            del s
        del docs
    return best_s, best_i


def corpus_rows(recipe, ids: torch.Tensor) -> torch.Tensor:
    """The Eq. 1-transformed corpus rows ``ids`` (U,) -> (U, D+1)."""
    norms = recipe.norms()
    m = float(norms.max())
    ids = ids.long()
    out = torch.empty(ids.shape[0], recipe.dim + 1, device=ids.device)
    for lo, hi, raw in recipe.blocks(norms):
        sel = (ids >= lo) & (ids < hi)
        if sel.any():
            out[sel] = eq1.documents(raw[ids[sel] - lo], m)
    return out
