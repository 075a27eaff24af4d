"""Fused wave ops over the stacked session caches, one launch each.

The port of ``repro.kernels.cache_wave.ops``:

  * ``wave_insert_query``   — insert scatter + post-insert top-k (the last
                              launch of a miss wave);
  * ``wave_query_topk``     — query only (a wave with no misses);
  * ``wave_insert_scatter`` — insert only.

All three run one kernel body (``csrc/cache_wave.cu``) in three modes on a
CUDA tensor, and ``ref`` on a CPU tensor.  They take the state arrays at
their physical extents and UPDATE THEM IN PLACE: the kept rows land at the
positions ``core.cache_ops.insert_positions`` computed (a position >= the
physical capacity is a drop), the record at ring slot ``qslot`` when
``rec``.  Per-wave inputs arrive already quantized and padded to the
state's width.  The LRU touch and step bump stay with the caller.  The
query takes any k up to the physical capacity (the logical capacity
included): every slot's key goes to a (S, Cp) f32 scratch and the block
select of ``csrc/select.cuh`` keeps the top k.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.cache_wave import ref

__all__ = ["wave_insert_query", "wave_query_topk", "wave_insert_scatter",
           "INSERT_QUERY", "QUERY_TOPK", "INSERT_SCATTER"]

INSERT_QUERY = dispatch.counter("wave_insert_query")
QUERY_TOPK = dispatch.counter("wave_query_topk")
INSERT_SCATTER = dispatch.counter("wave_insert_scatter")
_MODE = {"insert_query": 0, "query_topk": 1, "insert_scatter": 2}
_ARGS = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 24 + [ctypes.c_int] * 7
         + [ctypes.c_void_p])


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_state(doc_emb, doc_ids, doc_scale, doc_stamp=None):
    s, cp, dp = doc_emb.shape
    if doc_emb.dtype not in _build.STORE:
        raise TypeError(f"unsupported cache payload dtype {doc_emb.dtype}")
    if (dp * doc_emb.element_size()) % 32:
        raise ValueError(f"cache width {dp} is not padded to 32 bytes")
    for name, t, dt in (("doc_ids", doc_ids, torch.int32),
                        ("doc_scale", doc_scale, torch.float32),
                        ("doc_stamp", doc_stamp, torch.int32)):
        if t is None:
            continue
        if t.dtype != dt or tuple(t.shape) != (s, cp) or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {dt} {(s, cp)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if not doc_emb.is_contiguous():
        raise ValueError("doc_emb must be contiguous (updated in place)")


def _launch(mode, counter, doc_emb, doc_ids, doc_scale, doc_stamp=None,
            q_emb=None, q_radius=None, q_scale=None, emb_q=None,
            emb_scale=None, new_ids=None, pos=None, psi_q=None,
            psi_scale=None, radius=None, rec=None, qslot=None, step=None,
            psi=None, k=0):
    s, cp, dp = doc_emb.shape
    dev = doc_emb.device
    kc = qp = 0
    if emb_q is not None:
        kc, qp = emb_q.shape[1], q_emb.shape[1]
        if q_emb.dtype != doc_emb.dtype or emb_q.dtype != doc_emb.dtype \
                or psi_q.dtype != doc_emb.dtype:
            raise TypeError("record, insert and cache payloads must share "
                            "the storage dtype")
        if tuple(emb_q.shape) != (s, kc, dp) or tuple(psi_q.shape) != (s, dp) \
                or tuple(q_emb.shape) != (s, qp, dp):
            raise ValueError("insert operands are not at the state's width")
        if not (q_emb.is_contiguous() and q_radius.is_contiguous()
                and q_scale.is_contiguous()):
            raise ValueError("ring arrays must be contiguous (updated in place)")
        emb_q, psi_q = emb_q.contiguous(), psi_q.contiguous()
        emb_scale = emb_scale.to(torch.float32).contiguous()
        new_ids = new_ids.to(torch.int32).contiguous()
        pos = pos.to(torch.int32).contiguous()
        psi_scale = psi_scale.to(torch.float32).contiguous()
        radius = radius.to(torch.float32).contiguous()
        rec = rec.to(torch.int32).contiguous()
        qslot = qslot.to(torch.int32).contiguous()
        step = step.to(torch.int32).contiguous()
    vals = ids = slots = keys = pair_key = pair_pos = None
    kp = 0
    if psi is not None:
        if not 1 <= k <= cp:
            raise ValueError(f"k={k} outside [1, capacity {cp}]")
        psi = psi.to(torch.float32).contiguous()
        if tuple(psi.shape) != (s, dp):
            raise ValueError(f"psi {tuple(psi.shape)} != {(s, dp)}")
        vals = torch.empty((s, k), dtype=torch.float32, device=dev)
        ids = torch.empty((s, k), dtype=torch.int32, device=dev)
        slots = torch.empty((s, k), dtype=torch.int32, device=dev)
        keys = torch.empty((s, cp), dtype=torch.float32, device=dev)
        kp, pair_key, pair_pos = _build.pair_scratch(s, k, dev)
    fn = _build.function("cache_wave", "cache_wave", _ARGS)
    counter.launch()
    code = fn(_MODE[mode], _build.STORE[doc_emb.dtype], _ptr(doc_emb),
              _ptr(doc_ids), _ptr(doc_stamp), _ptr(doc_scale), _ptr(q_emb),
              _ptr(q_radius), _ptr(q_scale), _ptr(emb_q), _ptr(emb_scale),
              _ptr(new_ids), _ptr(pos), _ptr(psi_q), _ptr(psi_scale),
              _ptr(radius), _ptr(rec), _ptr(qslot), _ptr(step), _ptr(psi),
              _ptr(vals), _ptr(ids), _ptr(slots), _ptr(keys), _ptr(pair_key),
              _ptr(pair_pos), s, cp, dp, kc, qp, k, kp,
              _build.stream_of(doc_emb))
    _build.check(code, f"cache_wave ({mode})")
    return vals, ids, slots


def wave_query_topk(doc_emb, doc_ids, doc_scale, psi, k: int):
    """Per-session top-k over the cached docs.  doc_emb (S, Cp, Dp), doc_ids
    (S, Cp) with -1 empties, doc_scale (S, Cp) f32, psi (S, Dp) f32.
    Returns (vals (S, k) — -inf past the cached docs, ids (S, k) — -1
    there, slots (S, k)) in the stable top-k order."""
    QUERY_TOPK.call()
    if not dispatch.is_kernel(doc_emb):
        return ref.query_topk(doc_emb, doc_ids, doc_scale, psi, k)
    _check_state(doc_emb, doc_ids, doc_scale)
    return _launch("query_topk", QUERY_TOPK, doc_emb, doc_ids, doc_scale,
                   psi=psi, k=k)


def _insert(mode, counter, args, psi=None, k=0):
    (doc_emb, doc_ids, doc_stamp, doc_scale, q_emb, q_radius, q_scale, emb_q,
     emb_scale, new_ids, pos, psi_q, psi_scale, radius, rec, qslot,
     step) = args
    if not dispatch.is_kernel(doc_emb):
        ref.insert_scatter(*args)
        if psi is None:
            return None
        return ref.query_topk(doc_emb, doc_ids, doc_scale, psi, k)
    _check_state(doc_emb, doc_ids, doc_scale, doc_stamp)
    out = _launch(mode, counter, doc_emb, doc_ids, doc_scale, doc_stamp,
                  q_emb, q_radius, q_scale, emb_q, emb_scale, new_ids, pos,
                  psi_q, psi_scale, radius, rec, qslot, step, psi, k)
    return None if psi is None else out


def wave_insert_scatter(doc_emb, doc_ids, doc_stamp, doc_scale, q_emb,
                        q_radius, q_scale, emb_q, emb_scale, new_ids, pos,
                        psi_q, psi_scale, radius, rec, qslot, step) -> None:
    """Batched insert scatter, in place.  emb_q (S, kc, Dp) payload with
    emb_scale (S, kc); new_ids and pos (S, kc); the per-session record
    psi_q (S, Dp), psi_scale, radius, rec, qslot and the stamp ``step``
    (S,)."""
    INSERT_SCATTER.call()
    _insert("insert_scatter", INSERT_SCATTER,
            (doc_emb, doc_ids, doc_stamp, doc_scale, q_emb, q_radius, q_scale,
             emb_q, emb_scale, new_ids, pos, psi_q, psi_scale, radius, rec,
             qslot, step))


def wave_insert_query(doc_emb, doc_ids, doc_stamp, doc_scale, q_emb,
                      q_radius, q_scale, emb_q, emb_scale, new_ids, pos,
                      psi_q, psi_scale, radius, rec, qslot, step, psi,
                      k: int):
    """``wave_insert_scatter`` then ``wave_query_topk`` on the post-insert
    state, in ONE launch on the card.  Returns (vals, ids, slots)."""
    INSERT_QUERY.call()
    return _insert("insert_query", INSERT_QUERY,
                   (doc_emb, doc_ids, doc_stamp, doc_scale, q_emb, q_radius,
                    q_scale, emb_q, emb_scale, new_ids, pos, psi_q, psi_scale,
                    radius, rec, qslot, step), psi=psi, k=k)
