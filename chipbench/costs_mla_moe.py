"""Operations and bytes of an MLA + MoE query encoder's work, counted from
shapes and from the real tokens (``moonlight-16b-a3b``).

Kept with the benchmark beside ``costs.py``: they count what the inputs
need, not what an implementation does.  Pad positions are not counted
anywhere, so a change that computes pads is not rewarded.

  * ``encoder_flops``: each real token through every layer (MLA's
    projections, QK^T and PV over the causal half of the row, the dense
    layer's SwiGLU, the router, its k routed experts and the shared ones),
    then the pool's projection.
  * ``routed_work`` / ``shared_work``: one call of the expert products
    (``models.moe.expert_products``): 2 x 3 x d x f operations a token
    through an expert of width f; bytes the weights of each expert that
    took a token, read once, and the token rows in and out.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

BF16_FLOPS = 989e12          # H100 SXM dense bf16 tensor-core peak (700 W)
ELEM_BYTES = {"bfloat16": 2, "float32": 4}


def _mla_params(cfg: dict) -> int:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    dn, dr = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    dv, r = cfg["v_head_dim"], cfg["kv_lora_rank"]
    return (d * h * (dn + dr) + d * r + d * dr + r * h * dn + r * h * dv
            + h * dv * d)


def encoder_flops(cfg: dict, lengths: Sequence[int]) -> float:
    """Operations of one encoder call over rows of these real lengths."""
    d, n = cfg["hidden_size"], cfg["num_hidden_layers"]
    nd = cfg["first_k_dense_replace"]
    h = cfg["num_attention_heads"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    e, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    f = cfg["moe_intermediate_size"]
    fs = f * cfg["n_shared_experts"]
    dense = 2.0 * (_mla_params(cfg) + 3 * d * cfg["intermediate_size"])
    moe = 2.0 * (_mla_params(cfg) + d * e + 3 * d * f * k + 3 * d * fs)
    per_tok = nd * dense + (n - nd) * moe
    out = cfg["model"]["out_dim"]
    total = 0.0
    for m in lengths:
        m = int(m)
        attn = 2.0 * h * (qk + cfg["v_head_dim"]) * m * (m + 1) / 2.0
        total += per_tok * m + n * attn + 2.0 * d * out
    return total


def routed_work(cfg: dict, ends: np.ndarray) -> tuple[float, float]:
    """(operations, bytes) of one routed call: ``ends`` (E,) the ends of
    the experts' runs of rows (real tokens' choices only)."""
    d, f = cfg["hidden_size"], cfg["moe_intermediate_size"]
    eb = ELEM_BYTES[cfg["model"]["dtype"]]
    counts = np.diff(np.concatenate([[0], np.asarray(ends, np.int64)]))
    rows = float(counts.sum())
    hit = float((counts > 0).sum())
    return 6.0 * d * f * rows, hit * 3 * d * f * eb + 2.0 * rows * d * eb


def shared_work(cfg: dict, real: int) -> tuple[float, float]:
    """(operations, bytes) of one call of the shared experts over a
    layer's ``real`` tokens."""
    d = cfg["hidden_size"]
    fs = cfg["moe_intermediate_size"] * cfg["n_shared_experts"]
    eb = ELEM_BYTES[cfg["model"]["dtype"]]
    return 6.0 * d * fs * real, 3 * d * fs * eb + 2.0 * real * d * eb
