"""SASRec (arXiv:1808.09781), plain: item embeddings (pads zero) plus
learned positions, ``n_blocks`` pre-norm blocks of causal softmax
attention and a two-layer ReLU FFN with biases, RMSNorm as the program's
configuration states, the last real position's hidden state as the
session's query, and the exact top-k of its inner products with the item
table."""

from __future__ import annotations

import torch

from chipbench.reference import mm
from chipbench.reference.encoder import rms_norm


def session_repr(w: dict, items: torch.Tensor, cfg: dict,
                 precision: str = "f32") -> torch.Tensor:
    """(B, d) queries of item histories (B, S), right-padded with -1."""
    b, s = items.shape
    d, h = cfg["embed_dim"], cfg["n_heads"]
    dh = d // h
    mask = (items >= 0)[..., None].to(torch.float32)
    x = w["item_emb"][items.clamp(min=0).long()] * mask + w["pos_emb"][:s]
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    eps = 1e-6
    for blk in w["blocks"]:
        y = rms_norm(x, blk["norm1"], eps).reshape(b * s, d)
        q, k, v = (mm(y, blk[n], precision).view(b, s, h, dh).transpose(1, 2)
                   for n in ("wq", "wk", "wv"))
        sc = mm(q, k.transpose(-1, -2), precision) * dh ** -0.5
        att = torch.softmax(sc.masked_fill(~causal, float("-inf")), -1)
        o = mm(att, v, precision).transpose(1, 2).reshape(b * s, d)
        x = x + mm(o, blk["wo"], precision).view(b, s, d)
        y = rms_norm(x, blk["norm2"], eps).reshape(b * s, d)
        f0, f1 = blk["ffn"]
        y = torch.relu(mm(y, f0["w"], precision) + f0["b"])
        x = x + (mm(y, f1["w"], precision) + f1["b"]).view(b, s, d)
    x = rms_norm(x, w["final_norm"], eps) * mask
    last = ((items >= 0).sum(1) - 1).clamp(min=0)
    return x[torch.arange(b, device=x.device), last]


def topk(w: dict, query: torch.Tensor, k: int, precision: str = "f32",
         rows: int = 256):
    """(scores (B, k), ids (B, k)) of the whole item table, and the full
    score rows are not kept."""
    out_s, out_i = [], []
    for lo in range(0, query.shape[0], rows):
        s = mm(query[lo:lo + rows], w["item_emb"].T, precision)
        v, i = torch.topk(s, k, dim=1)
        out_s.append(v)
        out_i.append(i)
    return torch.cat(out_s), torch.cat(out_i)


def scores_of(w: dict, query: torch.Tensor, ids: torch.Tensor,
              precision: str = "f32") -> torch.Tensor:
    """The reference's score of each named item: (B, k)."""
    items = w["item_emb"][ids.clamp(min=0).long()]          # (B, k, d)
    if precision == "tf32":
        from chipbench.reference import to_tf32
        return (to_tf32(items) * to_tf32(query)[:, None, :]).sum(-1)
    return (items * query[:, None, :]).sum(-1)
