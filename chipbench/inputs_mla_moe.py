"""The seeded weights of an MLA + MoE query encoder (``moonlight-16b-a3b``),
as the program's parameter tree, drawn on the device one leaf at a time.

The configuration file holds the model's published ``config.json`` keys
(``num_hidden_layers``, ``hidden_size``, ...) and ``model``: the
weights' dtype and the projection's width.  Both sides get the same
weights: the program receives them, and the reference makes them again
from the seed.  Nothing here imports the program.
"""

from __future__ import annotations

import torch

from chipbench.inputs import generator

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def leaf_shapes(cfg: dict) -> dict:
    """{path: (shape, scale, offset, f32)}: every leaf of the tree, drawn
    as offset + scale * N(0, 1), in f32 where ``f32`` (norm scales, the
    router and its correction bias, the projection), else in the
    configuration's dtype.  Norm scales are 1 + 0.1 z so that a norm
    applied without its scale shows; the output projections are scaled
    down by sqrt(2 * layers), so that the residual stream stays of order
    one through the depth; the correction bias is 0.05 z, of the order of
    the gaps between the sigmoid scores near the k-th, so that it changes
    the choice of some tokens."""
    d, n = cfg["hidden_size"], cfg["num_hidden_layers"]
    nd = cfg["first_k_dense_replace"]
    h, v = cfg["num_attention_heads"], cfg["vocab_size"]
    dn, dr = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    dv, r = cfg["v_head_dim"], cfg["kv_lora_rank"]
    e, f = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    fs = f * cfg["n_shared_experts"]
    fd = cfg["intermediate_size"]
    down = (2 * n) ** -0.5
    out = {("embed",): ((v, d), 1.0, 0.0, False),
           ("final_norm",): ((d,), 0.1, 1.0, True)}
    for g, (kind, count) in enumerate((("dense", nd), ("moe", n - nd))):
        top = (f"group{g}_{kind}",)
        lead = (count,)
        attn = {"wq": ((d, h * (dn + dr)), d ** -0.5),
                "wdkv": ((d, r), d ** -0.5),
                "wkr": ((d, dr), d ** -0.5),
                "wuk": ((r, h * dn), r ** -0.5),
                "wuv": ((r, h * dv), r ** -0.5),
                "wo": ((h * dv, d), (h * dv) ** -0.5 * down)}
        for k, (shape, scale) in attn.items():
            out[top + ("attn", k)] = (lead + shape, scale, 0.0, False)
        out[top + ("attn", "kv_norm")] = (lead + (r,), 0.1, 1.0, True)
        out[top + ("pre_attn_norm",)] = (lead + (d,), 0.1, 1.0, True)
        out[top + ("pre_ffn_norm",)] = (lead + (d,), 0.1, 1.0, True)
        if kind == "dense":
            out[top + ("ffn", "wi")] = (lead + (d, 2 * fd), d ** -0.5, 0.0,
                                        False)
            out[top + ("ffn", "wo")] = (lead + (fd, d), fd ** -0.5 * down,
                                        0.0, False)
            continue
        ffn = {"router": ((d, e), d ** -0.5, True),
               "score_bias": ((e,), 0.05, True),
               "wi": ((e, d, 2 * f), d ** -0.5, False),
               "wo": ((e, f, d), f ** -0.5 * down, False),
               "shared_wi": ((d, 2 * fs), d ** -0.5, False),
               "shared_wo": ((fs, d), fs ** -0.5 * down, False)}
        for k, (shape, scale, f32) in ffn.items():
            out[top + ("ffn", k)] = (lead + shape, scale, 0.0, f32)
    out[("proj",)] = ((d, cfg["model"]["out_dim"]), d ** -0.5, 0.0,
                      True)
    return out


def encoder_weights(cfg: dict, seed: int, device) -> dict:
    """{"params": the program's tree (no LM head), "proj": (d, out_dim)
    f32}, each leaf from a generator of its own, so that either side can
    draw the same tree."""
    dtype = DTYPES[cfg["model"]["dtype"]]
    tree: dict = {}
    for i, (path, (shape, scale, offset, f32)) in enumerate(
            leaf_shapes(cfg).items()):
        g = generator(seed, "mla_moe", i, device=device)
        t = torch.randn(shape, generator=g, device=device,
                        dtype=torch.float32 if f32 else dtype).mul_(scale)
        if offset:
            t.add_(offset)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    proj = tree.pop("proj")
    return {"params": tree, "proj": proj}
