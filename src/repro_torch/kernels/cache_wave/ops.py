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
included).

``rows`` (W,) int32, when given, lets ``doc_emb`` be the whole stacked
(S_total, Cp, Dp) payload: wave row w reads and writes payload row
``rows[w]`` in place, so a wave copies no payload.  Every other argument
is per wave row.  Rows repeated to pad a wave must not insert (their
positions all drops, ``rec`` false): they read the payload their session's
own row is writing.

On the card the grid is (slot chunks, W): ``wave_grid`` sizes the chunks
from W and the physical capacity so that the blocks fill the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.cache_wave import ref

__all__ = ["wave_insert_query", "wave_query_topk", "wave_insert_scatter",
           "wave_grid", "INSERT_QUERY", "QUERY_TOPK", "INSERT_SCATTER"]

INSERT_QUERY = dispatch.counter("wave_insert_query")
QUERY_TOPK = dispatch.counter("wave_query_topk")
INSERT_SCATTER = dispatch.counter("wave_insert_scatter")
_MODE = {"insert_query": 0, "query_topk": 1, "insert_scatter": 2}
_ARGS = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 25 + [ctypes.c_int] * 8
         + [ctypes.c_void_p])
# csrc/cache_wave.cu: resident blocks per SM (__launch_bounds__) and the
# chunk multiple (the block's 16 warps)
BLOCKS_PER_SM = 2
CHUNK_ALIGN = 16


def wave_grid(s: int, cp: int, sms: int) -> tuple[int, int]:
    """(chunk, chunks): the slot chunk of one block and the chunks of a
    row.  While ``s`` rows fit, ``s * chunks`` stays within the
    ``BLOCKS_PER_SM * sms`` blocks the card holds at once (a second wave of
    blocks would leave most SMs idle) and fills them as far as whole
    ``CHUNK_ALIGN`` chunks allow; beyond, one block a row."""
    chunks = max(1, BLOCKS_PER_SM * sms // s)
    chunk = -(-cp // chunks)
    chunk = -(-chunk // CHUNK_ALIGN) * CHUNK_ALIGN
    return chunk, -(-cp // chunk)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_state(doc_emb, doc_ids, doc_scale, doc_stamp, rows):
    """W, the wave's row count, after checking the state's layout."""
    w, cp = doc_ids.shape
    if doc_emb.dtype not in _build.STORE:
        raise TypeError(f"unsupported cache payload dtype {doc_emb.dtype}")
    if doc_emb.dim() != 3 or doc_emb.shape[1] != cp:
        raise ValueError(f"doc_emb {tuple(doc_emb.shape)} does not hold "
                         f"{cp} slots per row")
    if (doc_emb.shape[2] * doc_emb.element_size()) % 32:
        raise ValueError(f"cache width {doc_emb.shape[2]} is not padded to "
                         f"32 bytes")
    if not doc_emb.is_contiguous():
        raise ValueError("doc_emb must be contiguous (updated in place)")
    for name, t, dt in (("doc_ids", doc_ids, torch.int32),
                        ("doc_scale", doc_scale, torch.float32),
                        ("doc_stamp", doc_stamp, torch.int32)):
        if t is None:
            continue
        if t.dtype != dt or tuple(t.shape) != (w, cp) or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {dt} {(w, cp)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if rows is None:
        if doc_emb.shape[0] != w:
            raise ValueError(f"doc_emb holds {doc_emb.shape[0]} rows for a "
                             f"wave of {w}; pass rows=")
    elif rows.dtype != torch.int32 or tuple(rows.shape) != (w,) \
            or rows.device != doc_emb.device:
        raise ValueError(f"rows: expected int32 ({w},) on {doc_emb.device}, "
                         f"got {rows.dtype} {tuple(rows.shape)} on "
                         f"{rows.device}")
    if w > 65535:
        raise ValueError(f"{w} wave rows exceed the grid's 65535")
    return w


def _launch(mode, counter, doc_emb, doc_ids, doc_scale, doc_stamp=None,
            q_emb=None, q_radius=None, q_scale=None, emb_q=None,
            emb_scale=None, new_ids=None, pos=None, psi_q=None,
            psi_scale=None, radius=None, rec=None, qslot=None, step=None,
            psi=None, k=0, rows=None):
    w = _check_state(doc_emb, doc_ids, doc_scale, doc_stamp, rows)
    cp, dp = doc_emb.shape[1:]
    dev = doc_emb.device
    kc = qp = 0
    if emb_q is not None:
        kc, qp = emb_q.shape[1], q_emb.shape[1]
        if q_emb.dtype != doc_emb.dtype or emb_q.dtype != doc_emb.dtype \
                or psi_q.dtype != doc_emb.dtype:
            raise TypeError("record, insert and cache payloads must share "
                            "the storage dtype")
        if tuple(emb_q.shape) != (w, kc, dp) or tuple(psi_q.shape) != (w, dp) \
                or tuple(q_emb.shape) != (w, qp, dp):
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
        if tuple(psi.shape) != (w, dp):
            raise ValueError(f"psi {tuple(psi.shape)} != {(w, dp)}")
        # the answers (vals as f32 bits, ids, slots), then the key scratch
        # and the row tickets: two allocations a call
        out = torch.empty((3, w, k), dtype=torch.int32, device=dev)
        vals, ids, slots = out[0].view(torch.float32), out[1], out[2]
        keys = torch.empty((w * (cp + 1),), dtype=torch.float32, device=dev)
        kp, pair_key, pair_pos = _build.pair_scratch(w, k, dev)
    chunk, _ = wave_grid(w, cp, _sms(dev.index))
    fn = _build.function("cache_wave", "cache_wave", _ARGS)
    counter.launch()
    code = fn(_MODE[mode], _build.STORE[doc_emb.dtype], doc_emb.data_ptr(),
              _ptr(rows), doc_ids.data_ptr(), _ptr(doc_stamp),
              doc_scale.data_ptr(), _ptr(q_emb), _ptr(q_radius),
              _ptr(q_scale), _ptr(emb_q), _ptr(emb_scale), _ptr(new_ids),
              _ptr(pos), _ptr(psi_q), _ptr(psi_scale), _ptr(radius),
              _ptr(rec), _ptr(qslot), _ptr(step), _ptr(psi), _ptr(vals),
              _ptr(ids), _ptr(slots), _ptr(keys), _ptr(pair_key),
              _ptr(pair_pos), w, cp, dp, kc, qp, k, kp, chunk,
              _build.stream_of(doc_emb))
    _build.check(code, f"cache_wave ({mode})")
    return vals, ids, slots


@dispatch.kernel_extent
def wave_query_topk(doc_emb, doc_ids, doc_scale, psi, k: int, rows=None):
    """Per-row top-k over the cached docs.  doc_emb (W, Cp, Dp) — or the
    stacked payload with ``rows`` — doc_ids (W, Cp) with -1 empties,
    doc_scale (W, Cp) f32, psi (W, Dp) f32.  Returns (vals (W, k) — -inf
    past the cached docs, ids (W, k) — -1 there, slots (W, k)) in the
    stable top-k order."""
    QUERY_TOPK.call()
    if not dispatch.is_kernel(doc_emb):
        return ref.query_topk(doc_emb, doc_ids, doc_scale, psi, k, rows)
    return _launch("query_topk", QUERY_TOPK, doc_emb, doc_ids, doc_scale,
                   psi=psi, k=k, rows=rows)


def _insert(mode, counter, args, psi=None, k=0, rows=None):
    (doc_emb, doc_ids, doc_stamp, doc_scale, q_emb, q_radius, q_scale, emb_q,
     emb_scale, new_ids, pos, psi_q, psi_scale, radius, rec, qslot,
     step) = args
    if not dispatch.is_kernel(doc_emb):
        ref.insert_scatter(*args, rows=rows)
        if psi is None:
            return None
        return ref.query_topk(doc_emb, doc_ids, doc_scale, psi, k, rows)
    out = _launch(mode, counter, doc_emb, doc_ids, doc_scale, doc_stamp,
                  q_emb, q_radius, q_scale, emb_q, emb_scale, new_ids, pos,
                  psi_q, psi_scale, radius, rec, qslot, step, psi, k, rows)
    return None if psi is None else out


@dispatch.kernel_extent
def wave_insert_scatter(doc_emb, doc_ids, doc_stamp, doc_scale, q_emb,
                        q_radius, q_scale, emb_q, emb_scale, new_ids, pos,
                        psi_q, psi_scale, radius, rec, qslot, step,
                        rows=None) -> None:
    """Batched insert scatter, in place.  emb_q (W, kc, Dp) payload with
    emb_scale (W, kc); new_ids and pos (W, kc); the per-row record psi_q
    (W, Dp), psi_scale, radius, rec, qslot and the stamp ``step`` (W,)."""
    INSERT_SCATTER.call()
    _insert("insert_scatter", INSERT_SCATTER,
            (doc_emb, doc_ids, doc_stamp, doc_scale, q_emb, q_radius, q_scale,
             emb_q, emb_scale, new_ids, pos, psi_q, psi_scale, radius, rec,
             qslot, step), rows=rows)


@dispatch.kernel_extent
def wave_insert_query(doc_emb, doc_ids, doc_stamp, doc_scale, q_emb,
                      q_radius, q_scale, emb_q, emb_scale, new_ids, pos,
                      psi_q, psi_scale, radius, rec, qslot, step, psi,
                      k: int, rows=None):
    """``wave_insert_scatter`` then ``wave_query_topk`` on the post-insert
    state, in ONE launch on the card.  Returns (vals, ids, slots)."""
    INSERT_QUERY.call()
    return _insert("insert_query", INSERT_QUERY,
                   (doc_emb, doc_ids, doc_stamp, doc_scale, q_emb, q_radius,
                    q_scale, emb_q, emb_scale, new_ids, pos, psi_q, psi_scale,
                    radius, rec, qslot, step), psi=psi, k=k, rows=rows)
