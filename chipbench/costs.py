"""Operations and bytes of the work a cell asks for, counted from shapes.

These are the yardstick's counts, kept with the benchmark: they count what
the inputs need, not what an implementation happens to do, so that a
faster kernel or a fused one is judged on the same work.

  * ``encoder_flops``: a causal transformer over the real tokens of each
    row (the products of every layer's weights, and QK^T and PV over the
    causal half of each row's positions), the mean pool and the
    projection.  Pad positions are not counted.
  * ``knn_search``: the exact top-k of B queries over N stored rows: 2 B N
    D operations at the logical width D, and each input and output byte
    once: the stored corpus, the queries and the (B, k) scores and ids.
    The (B, N) score scratch an implementation may write is not counted.
  * ``seqrec_flops``: SASRec's blocks over each row's real items and the
    scoring of the last position against the item table.
"""

from __future__ import annotations

from typing import Sequence


def encoder_layer_params(d: int, n_heads: int, n_kv: int, d_head: int,
                         d_ff: int) -> int:
    """Weights of one dense layer: q, k, v, o and the gated FFN."""
    return (d * n_heads * d_head + 2 * d * n_kv * d_head
            + n_heads * d_head * d + d * 2 * d_ff + d_ff * d)


def encoder_flops(enc: dict, lengths: Sequence[int]) -> float:
    """Operations of one encoder call over rows of these real lengths."""
    per_layer = encoder_layer_params(enc["d_model"], enc["n_heads"],
                                     enc["n_kv_heads"], enc["d_head"],
                                     enc["d_ff"])
    hd = enc["n_heads"] * enc["d_head"]
    total = 0.0
    for n in lengths:
        n = int(n)
        dense = 2.0 * per_layer * n
        attn = 2.0 * 2.0 * hd * n * (n + 1) / 2.0    # QK^T and PV, causal
        total += enc["n_layers"] * (dense + attn)
        total += 2.0 * enc["d_model"] * enc["out_dim"]   # the projection
    return total


def knn_search(b: int, n: int, dim: int, stored_width: int, k: int,
               elem_bytes: int = 4) -> tuple[float, float]:
    """(operations, bytes) of an exact top-k search of ``b`` queries."""
    flops = 2.0 * b * n * dim
    nbytes = (n * stored_width * elem_bytes          # the stored corpus
              + b * stored_width * 4                 # the queries
              + b * k * 8)                           # scores and ids out
    return flops, float(nbytes)


def seqrec_flops(d: int, n_blocks: int, d_ff_mult: int,
                 lengths: Sequence[int], vocab: int) -> float:
    """Operations of one SASRec retrieval over rows of these real lengths:
    the blocks (q, k, v, o, the FFN, causal attention) and the scoring of
    each row's last position against ``vocab`` items."""
    per_tok = 2.0 * (4 * d * d + 2 * d * d_ff_mult * d)
    total = 0.0
    for n in lengths:
        n = int(n)
        total += n_blocks * (per_tok * n + 2.0 * 2.0 * d * n * (n + 1) / 2)
    return total + 2.0 * len(lengths) * vocab * d
