"""Plain PyTorch version of the wave kernel (``csrc/cache_wave.cu``).

``insert_scatter`` writes the kept rows at their precomputed positions
(positions outside [0, Cp) are drops) and the (psi, r_a, scale) record at
the ring slot when ``rec`` is set — in place, like the kernel.
``query_topk`` scores every slot (f32 dot times the slot scale, -inf for
empty slots) and keeps the first k of a stable descending sort, so empty
slots come last in ascending order.  With ``rows``, ``doc_emb`` is the
stacked payload and wave row w's payload is row ``rows[w]``: the insert
writes it through the index, the query reads an ``index_select`` of it.
"""

from __future__ import annotations

import torch


def insert_scatter(doc_emb, doc_ids, doc_stamp, doc_scale, q_emb, q_radius,
                   q_scale, emb_q, emb_scale, new_ids, pos, psi_q, psi_scale,
                   radius, rec, qslot, step, rows=None) -> None:
    cp = doc_ids.shape[1]
    w, cols = torch.nonzero((pos >= 0) & (pos < cp), as_tuple=True)
    p = pos[w, cols].long()
    doc_emb[w if rows is None else rows.long()[w], p] = emb_q[w, cols]
    doc_ids[w, p] = new_ids[w, cols]
    doc_scale[w, p] = emb_scale[w, cols]
    doc_stamp[w, p] = step[w]
    r = torch.nonzero(rec, as_tuple=True)[0]
    slot = qslot[r].long()
    q_emb[r, slot] = psi_q[r]
    q_radius[r, slot] = radius[r]
    q_scale[r, slot] = psi_scale[r]


def query_topk(doc_emb, doc_ids, doc_scale, psi, k: int, rows=None):
    """(vals (W, k) f32, ids (W, k) int32, slots (W, k) int32)."""
    if rows is not None:
        doc_emb = doc_emb.index_select(0, rows)
    scores = torch.bmm(doc_emb.to(torch.float32), psi[:, :, None])[..., 0]
    scores = torch.where(doc_ids >= 0, scores * doc_scale,
                         torch.tensor(float("-inf"), device=scores.device))
    vals, slots = torch.sort(scores, dim=1, descending=True, stable=True)
    vals, slots = vals[:, :k], slots[:, :k]
    return vals, torch.gather(doc_ids, 1, slots), slots.to(torch.int32)
