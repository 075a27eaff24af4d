"""The query encoder, plain: a causal transformer (pre-norm RMSNorm,
rotary positions on every head dimension, softmax attention, a SiLU-gated
FFN), the final norm, the mean of the real positions' hidden states, the
projection, and the query side of Eq. 1 (unit norm, a zero appended).

It follows the program's configuration of the STAR encoder, whose
departures from the published RoBERTa-base encoder (rotary positions and
RMSNorm in place of learned positions and LayerNorm) are listed under
``assumed`` in the configuration file.  Pad tokens (-1) follow the real
ones; the causal mask keeps them out of every real position, and the pool
leaves them out.
"""

from __future__ import annotations

import torch

from chipbench.reference import mm


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, Dh): the two halves of each head rotate by the
    position times 1 / theta^(2i / Dh)."""
    s, dh = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                         device=x.device) / dh)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def encode(weights: dict, tokens: torch.Tensor, enc: dict,
           precision: str = "f32") -> torch.Tensor:
    """psi (B, out_dim + 1) of token rows (B, S), right-padded with -1."""
    p, proj = weights["params"], weights["proj"]
    layers = p["group0_dense"]
    b, s = tokens.shape
    h, kv, dh = enc["n_heads"], enc["n_kv_heads"], enc["d_head"]
    eps = enc["norm_eps"]
    mask = tokens >= 0
    x = p["embed"][tokens.clamp(min=0).long()]
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    for i in range(enc["n_layers"]):
        a = layers["attn"]
        y = rms_norm(x, layers["pre_attn_norm"][i], eps).reshape(b * s, -1)
        q = mm(y, a["wq"][i], precision).view(b, s, h, dh)
        k = mm(y, a["wk"][i], precision).view(b, s, kv, dh)
        v = mm(y, a["wv"][i], precision).view(b, s, kv, dh)
        q, k = rope(q, enc["rope_theta"]), rope(k, enc["rope_theta"])
        k = k.repeat_interleave(h // kv, dim=2)
        v = v.repeat_interleave(h // kv, dim=2)
        scores = mm(q.transpose(1, 2), k.permute(0, 2, 3, 1), precision) \
            * dh ** -0.5
        w = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
        o = mm(w, v.transpose(1, 2), precision).transpose(1, 2)
        x = x + mm(o.reshape(b * s, h * dh), a["wo"][i],
                   precision).view(b, s, -1)
        f = layers["ffn"]
        y = rms_norm(x, layers["pre_ffn_norm"][i], eps).reshape(b * s, -1)
        gate, up = mm(y, f["wi"][i], precision).chunk(2, dim=-1)
        x = x + mm(torch.nn.functional.silu(gate) * up, f["wo"][i],
                   precision).view(b, s, -1)
    x = rms_norm(x, p["final_norm"], eps)
    m = mask[..., None].to(x.dtype)
    pooled = (x * m).sum(1) / m.sum(1).clamp(min=1)
    out = mm(pooled, proj, precision)
    out = out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)
    return torch.cat([out, out.new_zeros(b, 1)], dim=-1)


def encode_rows(weights: dict, tokens: torch.Tensor, enc: dict,
                precision: str = "f32", rows: int = 256) -> torch.Tensor:
    """``encode`` over row blocks, so that a large pool fits."""
    return torch.cat([encode(weights, tokens[lo:lo + rows], enc, precision)
                      for lo in range(0, tokens.shape[0], rows)])
