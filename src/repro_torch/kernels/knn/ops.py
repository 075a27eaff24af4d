"""Exact top-k MIPS over the corpus: the miss search of every serving wave.

The port of ``repro.kernels.knn.ops.knn_search`` (fused path).  The wrapper
pads the queries to the corpus width, quantizes them per row to int8 under
the int8-dot rule (so the kernel and the plain version score the same
payload, as ``knn/ops.py:152-157`` does), and handles k > N by padding the
answer with (-inf, -1).  On a CUDA tensor the search is two launches of
``csrc/knn.cu`` — ``knn_score`` into a (B, N) f32 scratch, then
``knn_select`` — and counts as one op; on a CPU tensor it runs
``ref.search``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import layout, quant
from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.knn import ref

__all__ = ["knn_score", "knn_select", "knn_search", "SCORE", "SELECT",
           "MAX_K"]

SCORE = dispatch.counter("knn_score")
SELECT = dispatch.counter("knn_select")
MAX_K = 1024
_SCORE_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong]
               + [ctypes.c_int] * 3 + [ctypes.c_void_p])
_SELECT_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong,
                                         ctypes.c_int, ctypes.c_void_p])


def _check(t, name, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def knn_score(docs, doc_ids, queries, scale=None, q_scale=None):
    """Masked (B, N) f32 scores; ``q_scale`` given means int8-dot queries."""
    if not dispatch.is_kernel(docs):
        return ref.score(docs, doc_ids, queries, scale, q_scale)
    n, dp = docs.shape
    b = queries.shape[0]
    dev = docs.device
    if docs.dtype not in _build.STORE:
        raise TypeError(f"unsupported corpus dtype {docs.dtype}")
    if dp % layout.FEAT:       # the score kernel's feature tile (BK)
        raise ValueError(f"corpus width {dp} is not a multiple of "
                         f"{layout.FEAT}")
    if n >= 2 ** 31:
        raise ValueError(f"corpus of {n} rows exceeds int32 positions")
    i8 = q_scale is not None
    _check(queries, "queries", torch.int8 if i8 else torch.float32, (b, dp), dev)
    _check(doc_ids, "doc_ids", torch.int32, (n,), dev)
    if scale is not None:
        _check(scale, "scale", torch.float32, (n,), dev)
    if i8:
        _check(q_scale, "q_scale", torch.float32, (b,), dev)
        if docs.dtype != torch.int8:
            raise TypeError("int8-dot scoring needs an int8 corpus")
    docs, doc_ids, queries = (t.contiguous() for t in (docs, doc_ids, queries))
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    fn = _build.function("knn", "knn_score", _SCORE_ARGS)
    SCORE.launch()
    code = fn(queries.data_ptr(), q_scale.data_ptr() if i8 else None,
              docs.data_ptr(), doc_ids.data_ptr(),
              None if scale is None else scale.contiguous().data_ptr(),
              out.data_ptr(), b, n, dp, _build.STORE[docs.dtype], int(i8),
              _build.stream_of(docs))
    _build.check(code, "knn_score")
    return out


def knn_select(scores, doc_ids, k: int):
    """Stable top-k of (B, N) scores: (vals (B, k) f32, ids (B, k) int32)."""
    if not dispatch.is_kernel(scores):
        return ref.select(scores, doc_ids, k)
    b, n = scores.shape
    if not 1 <= k <= min(n, MAX_K):
        raise ValueError(f"k={k} outside [1, min(N={n}, {MAX_K})]")
    _check(doc_ids, "doc_ids", torch.int32, (n,), scores.device)
    scores = scores.contiguous()
    vals = torch.empty((b, k), dtype=torch.float32, device=scores.device)
    ids = torch.empty((b, k), dtype=torch.int32, device=scores.device)
    fn = _build.function("knn", "knn_select", _SELECT_ARGS)
    SELECT.launch()
    code = fn(scores.data_ptr(), doc_ids.contiguous().data_ptr(),
              vals.data_ptr(), ids.data_ptr(), b, n, k,
              _build.stream_of(scores))
    _build.check(code, "knn_select")
    return vals, ids


def knn_search(docs: torch.Tensor, doc_ids: torch.Tensor,
               queries: torch.Tensor, k: int,
               scale: torch.Tensor | None = None,
               int8_dot: bool | None = None):
    """Top-k MIPS.  docs (N, Dp) fp32 / bf16 / int8 payload with ``scale``
    its (N,) f32 per-document multiplier (None = unquantized); doc_ids (N,)
    int32, -1 on sentinel rows; queries (B, d <= Dp) f32.  ``int8_dot``
    (None = the ``REPRO_INT8_DOT`` policy, int8 corpora only) scores int8 x
    int8 in int32.  Returns (scores (B, k) descending, ids (B, k), -1 where
    the score is -inf)."""
    SCORE.call()
    SELECT.call()
    n, dp = docs.shape
    q = torch.nn.functional.pad(queries.to(torch.float32),
                                (0, dp - queries.shape[1]))
    q_scale = None
    if quant.resolve_int8_dot(int8_dot, docs.dtype):
        qq = quant.quantize(q, "int8")
        q, q_scale = qq.data, qq.scale
    if not dispatch.is_kernel(docs):
        return ref.search(docs, doc_ids, q, k, scale, q_scale)
    k_eff = min(k, n)
    if k_eff > MAX_K:
        raise ValueError(f"k={k} exceeds the select kernel's limit {MAX_K}")
    vals, ids = knn_select(knn_score(docs, doc_ids, q, scale, q_scale),
                           doc_ids, k_eff)
    if k_eff < k:
        vals = torch.nn.functional.pad(vals, (0, k - k_eff),
                                       value=float("-inf"))
        ids = torch.nn.functional.pad(ids, (0, k - k_eff), value=-1)
    return vals, ids
