"""Plain PyTorch versions of the kNN kernels (``csrc/knn.cu``).

One masked (B, N) score matrix and stable descending sorts, so equal
scores keep the lower corpus position (``lax.top_k``'s order); -inf
results carry id -1 and k > N pads with (-inf, -1).  The scores are taken
``QUERY_TILE`` queries at a time (the score GEMM's query tile, owned by
``kernels/_build.py``), one matrix product per block: a BLAS
sums a row in an order that can depend on how many rows the product
holds, and blocks aligned to the search's chunks (``ops.chunk_rows``, a
multiple of the block) make a chunked search equal the unchunked one bit
for bit.  ``score`` is the
plain version of the score kernel, ``select`` of the select kernel,
``search`` of the fused op, ``tile_topk`` of the two-stage scan's tile
kernel and ``merge_tiles`` of its merge (``ops.merge_tiles``, which
selects through ``knn_select``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import QUERY_TILE


def score(docs: torch.Tensor, doc_ids: torch.Tensor, queries: torch.Tensor,
          scale: torch.Tensor | None = None,
          q_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Masked (B, N) f32 scores.  With ``q_scale`` the queries are an int8
    payload and the dot is the exact integer sum (taken in f64, exact for
    any practical width), scaled as (f32(acc) * q_scale) * scale."""
    wide = torch.float32 if q_scale is None else torch.float64
    d = docs.to(wide).T
    q = queries.to(wide)
    parts = [(q[lo:lo + QUERY_TILE] @ d).to(torch.float32)
             for lo in range(0, max(q.shape[0], 1), QUERY_TILE)]
    scores = parts[0] if len(parts) == 1 else torch.cat(parts)
    if q_scale is not None:
        scores = scores * q_scale[:, None]
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


def tile_topk(docs, doc_ids, queries, k_eff: int, tile_n: int, scale=None,
              q_scale=None):
    """Per-tile stable top ``k_eff`` over the scores padded with -inf to a
    ``tile_n`` multiple: (vals, positions), each the (tiles, B, k_eff) view
    of a (B, tiles, k_eff) buffer, as the kernel returns them."""
    s = score(docs, doc_ids, queries, scale, q_scale)
    b, n = s.shape
    tiles = -(-n // tile_n)
    s = torch.nn.functional.pad(s, (0, tiles * tile_n - n),
                                value=float("-inf")).view(b, tiles, tile_n)
    vals, pos = torch.sort(s, dim=2, descending=True, stable=True)
    base = torch.arange(tiles, device=s.device)[None, :, None] * tile_n
    pos = (pos[..., :k_eff] + base).to(torch.int32)
    return (vals[..., :k_eff].contiguous().permute(1, 0, 2),
            pos.contiguous().permute(1, 0, 2))


def merge_tiles(vals: torch.Tensor, pos: torch.Tensor, doc_ids: torch.Tensor,
                k: int):
    """The two-stage merge: the stable top-k of the (tiles, B, k_eff)
    candidates in tile-major order (equal scores keep the lower corpus
    position), -inf results taking id -1."""
    tiles, b, ke = vals.shape
    v = vals.permute(1, 0, 2).reshape(b, tiles * ke)
    p = pos.permute(1, 0, 2).reshape(b, tiles * ke)
    top_s, order = torch.sort(v, dim=1, descending=True, stable=True)
    top_s, order = top_s[:, :k], order[:, :k]
    top_p = torch.gather(p, 1, order).long()
    n = doc_ids.shape[0]
    found = doc_ids[top_p.clamp(0, n - 1)]
    top_i = torch.where(torch.isneginf(top_s) | (top_p >= n),
                        torch.tensor(-1, dtype=doc_ids.dtype,
                                     device=doc_ids.device), found)
    return top_s, top_i
