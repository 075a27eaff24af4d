"""Moonlight-16B-A3B as a query encoder, plain: DeepSeek-V3's decoder
(``model_type`` deepseek_v3) as its published ``config.json`` sets it up,
then the mean of the real positions' final hidden states, the projection
and the query side of Eq. 1 (unit norm, a zero appended).

Each layer: RMSNorm, MLA attention, RMSNorm, then the first layer's
SwiGLU or a MoE FFN.  MLA with no query latent: q = x W_q per head (128
no-rope + 64 rope dims); the kv latent c = RMSNorm(x W_dkv) (512), keys
[c W_uk, rope(x W_kr)] with the one rope head shared by every head,
values c W_uv; causal softmax attention scaled by 192^-0.5.  The MoE FFN:
sigmoid scores s = sigmoid(x W_r) in f32; the 6 experts of the largest s
+ b (b the correction bias; one group, so the group choice selects
nothing); gates the chosen s over their sum (+ 1e-20) times 2.446; each
routed expert computed by a loop over the tokens that chose it; plus the
shared experts (one SwiGLU of width 2,816) on every token.

Departures from the published model, as the program has them: rotary
positions rotate the two halves of the 64 rope dims (the published
weights' layout pairs neighbouring dims; with seeded weights the two are
the same function up to a fixed permutation of W_q's and W_kr's rope
columns); the hidden states are mean-pooled over the real positions, as
the ``cast19-star`` encoder pools, and no LM head is held.  Pads (-1)
follow the real tokens: the causal mask keeps them out of every real
position, the routing of one token never depends on another, and the
pool leaves them out, so they are computed here and read by nothing.

``precision``: "f32" (each layer's weights upcast to f32 one layer at a
time, products in full float32: TF32 off), "bf16" (every product's
operands in bf16, f32 sums, a bf16 result: what the configuration's
bf16 products compute) or "fp8" (every product's operands scaled per
tensor into float8 e4m3 and back, summed in f32: the control, one step
below the configuration's bf16).  The router's product, the norms, the
pool and the projection stay in f32 at every precision, as the
configuration states them.  Activations stay f32 between the products.
"""

from __future__ import annotations

import torch

from chipbench.reference.encoder import rms_norm, rope

PRECISIONS = ("f32", "bf16", "fp8")
E4M3_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) scaled by its largest magnitude into e4m3 and back."""
    amax = x.abs().max().clamp(min=1e-12)
    scale = amax / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` as ``precision`` computes it, as float32."""
    if precision == "f32":
        return a.float() @ b.float()
    if precision == "bf16":
        return (a.to(torch.bfloat16) @ b.to(torch.bfloat16)).float()
    if precision == "fp8":
        return _fp8(a.float()) @ _fp8(b.float())
    raise ValueError(f"precision {precision!r}: expected {PRECISIONS}")


def _swiglu(x, wi, wo, precision):
    gate, up = mm(x, wi, precision).chunk(2, dim=-1)
    return mm(torch.nn.functional.silu(gate) * up, wo, precision)


def _layer(group: dict, i: int, precision: str) -> dict:
    """Layer ``i`` of a stacked group, upcast to f32 (kept as it is for
    "bf16": the products cast their operands)."""
    def pick(t):
        if isinstance(t, dict):
            return {k: pick(v) for k, v in t.items()}
        return t[i] if precision == "bf16" else t[i].float()
    return pick(group)


def attention(a: dict, y: torch.Tensor, enc: dict,
              precision: str) -> torch.Tensor:
    """MLA of the normed rows y (B, S, d), causal: (B, S, d)."""
    b, s, _ = y.shape
    h = enc["num_attention_heads"]
    dn, dr = enc["qk_nope_head_dim"], enc["qk_rope_head_dim"]
    dv, eps = enc["v_head_dim"], enc["rms_norm_eps"]
    theta = float(enc["rope_theta"])
    flat = y.reshape(b * s, -1)
    q = mm(flat, a["wq"], precision).view(b, s, h, dn + dr)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], theta)], dim=-1)
    c = rms_norm(mm(flat, a["wdkv"], precision), a["kv_norm"], eps)
    kr = rope(mm(flat, a["wkr"], precision).view(b, s, 1, dr), theta)
    k = torch.cat([mm(c, a["wuk"], precision).view(b, s, h, dn),
                   kr.expand(b, s, h, dr)], dim=-1)
    v = mm(c, a["wuv"], precision).view(b, s, h, dv)
    scores = mm(q.transpose(1, 2), k.permute(0, 2, 3, 1), precision) \
        * (dn + dr) ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool, device=y.device).tril()
    w = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
    o = mm(w, v.transpose(1, 2), precision).transpose(1, 2)
    return mm(o.reshape(b * s, h * dv), a["wo"], precision).view(b, s, -1)


def route(f: dict, y: torch.Tensor, enc: dict):
    """(gates (T, k), experts (T, k)) of rows y (T, d): DeepSeek-V3's
    choice by the biased sigmoid score, gated by the unbiased one."""
    scores = torch.sigmoid(y.float() @ f["router"].float())
    ids = torch.topk(scores + f["score_bias"].float(),
                     enc["num_experts_per_tok"], dim=-1).indices
    gates = scores.gather(1, ids)
    if enc["norm_topk_prob"]:
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-20)
    return gates * enc["routed_scaling_factor"], ids


def moe(f: dict, y: torch.Tensor, enc: dict, precision: str) -> torch.Tensor:
    """The MoE FFN of rows y (T, d): routed experts by a loop over the
    tokens that chose each, and the shared experts."""
    gates, ids = route(f, y, enc)
    out = torch.zeros(y.shape, dtype=torch.float32, device=y.device)
    for e in range(enc["n_routed_experts"]):
        tok, slot = (ids == e).nonzero(as_tuple=True)
        if tok.numel():
            got = _swiglu(y[tok], f["wi"][e], f["wo"][e], precision)
            out.index_add_(0, tok, got * gates[tok, slot, None])
    return out + _swiglu(y, f["shared_wi"], f["shared_wo"], precision)


def encode(weights: dict, tokens: torch.Tensor, enc: dict,
           precision: str = "f32") -> torch.Tensor:
    """psi (B, out_dim + 1) of token rows (B, S), right-padded with -1."""
    p, proj = weights["params"], weights["proj"]
    b, s = tokens.shape
    eps = enc["rms_norm_eps"]
    mask = tokens >= 0
    x = p["embed"][tokens.clamp(min=0).long()].float()
    layers = [(p["group0_dense"], i, "dense")
              for i in range(enc["first_k_dense_replace"])]
    layers += [(p["group1_moe"], i, "moe") for i in range(
        enc["num_hidden_layers"] - enc["first_k_dense_replace"])]
    for group, i, kind in layers:
        w = _layer(group, i, precision)
        x = x + attention(w["attn"], rms_norm(x, w["pre_attn_norm"], eps),
                          enc, precision)
        y = rms_norm(x, w["pre_ffn_norm"], eps).reshape(b * s, -1)
        f = w["ffn"]
        if kind == "dense":
            y = _swiglu(y, f["wi"], f["wo"], precision)
        else:
            y = moe(f, y, enc, precision)
        x = x + y.view(b, s, -1)
        del w
    x = rms_norm(x, p["final_norm"].float(), eps)
    m = mask[..., None].to(x.dtype)
    pooled = (x * m).sum(1) / m.sum(1).clamp(min=1)
    out = pooled @ proj.float()
    out = out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)
    return torch.cat([out, out.new_zeros(b, 1)], dim=-1)


def encode_rows(weights: dict, tokens: torch.Tensor, enc: dict,
                precision: str = "f32", rows: int = 64) -> torch.Tensor:
    """``encode`` over row blocks, so that a large pool fits."""
    return torch.cat([encode(weights, tokens[lo:lo + rows], enc, precision)
                      for lo in range(0, tokens.shape[0], rows)])
