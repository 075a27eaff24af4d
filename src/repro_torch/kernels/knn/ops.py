"""Exact top-k MIPS over the corpus: the miss search of every serving wave,
and the two-stage scan kept as its A/B baseline.

The port of ``repro.kernels.knn.ops.knn_search``.  The wrapper pads the
queries to the corpus width, quantizes them per row to int8 under the
int8-dot rule (so the kernel and the plain version score the same payload,
as ``knn/ops.py:152-157`` does), and handles k > N by padding the answer
with (-inf, -1).  Two paths, any k:

  * fused (default) — ``knn_score`` into a (B, N) f32 scratch, then
    ``knn_select`` (the stable top-k of each row, a radix select over all
    SMs): one op, two counted launches of ``csrc/knn.cu``.  ``knn_score``
    takes the single-query path (a GEMV) for B <= ``SCORE_GEMV_MAX_B`` and
    the batched GEMM above it;
  * ``two_stage=True`` — ``knn_tile_topk``, one kernel that scores every
    ``tile_n`` tile and keeps its stable top ``k_eff = min(k, tile_n)``
    positions on chip, writing (B, tiles, k_eff) candidates and no (B, N)
    scores; then the merge, ``merge_tiles``: ``knn_select`` over the
    tile-major candidates, -inf results taking id -1.  Two counted
    launches.  The corpus counts as padded to a tile multiple with id -1
    rows (the kernel reads positions past N as -inf; nothing is copied).
    When ``k_eff < k`` the answer can differ from the exact top-k: it is
    the JAX package's two-stage answer for the same ``tile_n``.  A tile
    wider than ``FUSED_MAX_TILE`` documents (the widest a cluster of
    blocks holds) has ``k_eff = k``: each tile keeps its whole share of
    the top k, and the merge orders ties by the lower corpus position, so
    the answer is the fused search's, and the fused search gives it.
    ``autotune_knn`` is the JAX tuner's arithmetic, so the default
    ``tile_n`` and ``k_eff`` equal the JAX ones.

On a CUDA tensor the kernels launch; on a CPU tensor the plain versions in
``ref`` run.  Every scratch buffer of the kernels (the select's
histograms, counters, candidates and filter buffers) is allocated here.

The scratch is bounded: ``knn_search`` answers the queries in chunks of
``chunk_rows`` rows, a multiple of the score GEMM's ``QUERY_TILE``, sized
so that one chunk's scratch fits ``SCRATCH_BUDGET`` bytes: the fused
search's (B_c, N) f32 scores and select scratch, the two-stage scan's
candidates and merge scratch (``two_stage_rows``); both devices chunk
alike.  A chunk holds at least one ``QUERY_TILE`` of queries, and that
floor is not bounded by the budget: one 64-query chunk of the two-stage
scan holds 64 x tiles x k_eff x 8 B of candidates, 4.53 GB at the tuned
fp32 tile over the 8,841,823-document corpus (8,842,240 candidates a row).  Rows are independent, and every chunk takes the score path that
the whole B chooses (a tail of <= ``SCORE_GEMV_MAX_B`` queries stays on the
GEMM), so the answers equal the unchunked search's bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import layout, quant
from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.knn import ref

__all__ = ["knn_score", "knn_select", "knn_tile_topk", "merge_tiles",
           "knn_search", "chunk_rows", "two_stage_rows", "autotune_knn",
           "SCORE", "SELECT", "TILE", "SCORE_GEMV_MAX_B", "FUSED_MAX_TILE",
           "SCRATCH_BUDGET", "QUERY_TILE", "MAX_ROWS"]

SCORE = dispatch.counter("knn_score")
SELECT = dispatch.counter("knn_select")
TILE = dispatch.counter("knn_tile_topk")           # the fused tile kernel
# the JAX tuner's padding rules (TPU lane and sublane), kept so that
# ``autotune_knn`` picks the JAX package's tile for the same call
LANE, SUBLANE = 128, 8
# the numbers csrc/knn.cu shares, owned by the build
SCORE_GEMV_MAX_B = _build.SCORE_GEMV_MAX_B
FUSED_MAX_TILE = _build.FUSED_MAX_TILE
QUERY_TILE = _build.QUERY_TILE
MAX_ROWS = _build.MAX_ROWS
SELECT_BUF = 1 << 16      # filter buffer per row (keys at the k-th digit)
# bytes one chunk of a search may hold in scratch: its (B_c, N) f32 scores
# and select scratch (64 queries over the 8,841,823-doc corpus take 2.3 GB)
SCRATCH_BUDGET = 4 << 30
_SCORE_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong]
               + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_SELECT_ARGS = ([ctypes.c_void_p] * 5
                + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
_TILE_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_longlong]
              + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(t, name, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def autotune_knn(n: int, d: int, b: int, k: int,
                 itemsize: int = 4) -> tuple[int, int]:
    """(tile_n, k_eff) of the JAX tuner (``knn/ops.py:43-76``): the largest
    power-of-two tile <= 4096 whose double-buffered working set fits 6 MB,
    and k_eff = min(k, tile_n)."""
    dp = d + (-d) % LANE
    bp = b + (-b) % SUBLANE
    cap = max(SUBLANE, layout.next_pow2(n))
    tile = min(4096, cap)
    budget = 6 * 2 ** 20

    def working_set(t: int) -> int:
        return (2 * t * (itemsize * dp + 8)
                + 4 * bp * dp + 8 * bp * k + 12 * bp * (k + t))

    while tile > SUBLANE and working_set(tile) > budget:
        tile //= 2
    return tile, min(k, tile)


def _check_aligned(t, name):
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernels load 16-byte vectors; the "
                         f"tensor starts at a {t.data_ptr() % 16}-byte offset")


@dispatch.kernel_extent
def knn_score(docs, doc_ids, queries, scale=None, q_scale=None):
    """Masked (B, N) f32 scores; ``q_scale`` given means int8-dot queries."""
    b = queries.shape[0]
    return _score(docs, doc_ids, queries, scale, q_scale,
                  gemv=b <= SCORE_GEMV_MAX_B)


def _operands(docs, doc_ids, queries, scale, q_scale):
    """The score kernels' operands checked and made contiguous: (docs,
    doc_ids, queries, scale, int8-dot)."""
    n, dp = docs.shape
    b = queries.shape[0]
    dev = docs.device
    if docs.dtype not in _build.PAYLOADS:
        raise TypeError(f"unsupported corpus dtype {docs.dtype}")
    if dp % _build.FEAT:       # the score kernel's feature tile
        raise ValueError(f"corpus width {dp} is not a multiple of "
                         f"{_build.FEAT}")
    if n >= 2 ** 31:
        raise ValueError(f"corpus of {n} rows exceeds int32 positions")
    i8 = q_scale is not None
    _check(queries, "queries", torch.int8 if i8 else torch.float32, (b, dp), dev)
    _check(doc_ids, "doc_ids", torch.int32, (n,), dev)
    if scale is not None:
        _check(scale, "scale", torch.float32, (n,), dev)
        scale = scale.contiguous()
    if i8:
        _check(q_scale, "q_scale", torch.float32, (b,), dev)
        if docs.dtype != torch.int8:
            raise TypeError("int8-dot scoring needs an int8 corpus")
    docs, doc_ids, queries = (t.contiguous() for t in (docs, doc_ids, queries))
    _check_aligned(docs, "docs")
    _check_aligned(queries, "queries")
    return docs, doc_ids, queries, scale, i8


def _score(docs, doc_ids, queries, scale, q_scale, *, gemv: bool):
    """``knn_score`` on the path asked for: the single-query GEMV
    (B <= ``SCORE_GEMV_MAX_B``) or the batched GEMM (any B)."""
    if not dispatch.is_kernel(docs):
        return ref.score(docs, doc_ids, queries, scale, q_scale)
    b = queries.shape[0]
    if gemv and b > SCORE_GEMV_MAX_B:
        raise ValueError(f"the single-query path takes at most "
                         f"{SCORE_GEMV_MAX_B} queries, got {b}")
    docs, doc_ids, queries, scale, i8 = _operands(docs, doc_ids, queries,
                                                  scale, q_scale)
    n, dp = docs.shape
    out = torch.empty((b, n), dtype=torch.float32, device=docs.device)
    fn = _build.function("knn", "knn_score", _SCORE_ARGS)
    SCORE.launch()
    code = fn(queries.data_ptr(), q_scale.data_ptr() if i8 else None,
              docs.data_ptr(), doc_ids.data_ptr(), _ptr(scale),
              out.data_ptr(), b, n, dp, _build.STORE[docs.dtype],
              int(i8), int(gemv), _build.stream_of(docs))
    _build.check(code, "knn_score")
    return out


def _select_words(n: int, k: int) -> tuple[int, int, int]:
    """(cap, bufcap, int32 words of scratch per row) of a select of the top
    ``k`` of ``n``: every key above the k-th plus its tie run, up to cap;
    the workspace (histograms, counters), candidates and filter buffers."""
    cap = 2 * layout.next_pow2(k)
    bufcap = min(n, SELECT_BUF)
    return cap, bufcap, _build.SELECT_WS + 2 * cap + 4 * bufcap


def chunk_rows(n: int, row_bytes: int) -> int:
    """Queries per chunk of a search whose query row holds ``n`` f32 scores
    (0 when it keeps none) and ``row_bytes`` of other scratch: the most that
    fit ``SCRATCH_BUDGET``, in whole ``QUERY_TILE``s (at least one), and
    never more than the grids' row limit."""
    rows = SCRATCH_BUDGET // (4 * n + row_bytes) // QUERY_TILE * QUERY_TILE
    return min(max(rows, QUERY_TILE), MAX_ROWS // QUERY_TILE * QUERY_TILE)


def two_stage_rows(n: int, tile_n: int, k_eff: int, k: int) -> int:
    """``chunk_rows`` of a two-stage search over ``n`` documents: a query
    row holds its tiles * k_eff candidates (value and position) and the
    merge's select scratch.  At least one ``QUERY_TILE``, even where that
    exceeds ``SCRATCH_BUDGET``."""
    cands = -(-n // tile_n) * k_eff
    return chunk_rows(0, 8 * cands + 4 * _select_words(cands, k)[2])


@dispatch.kernel_extent
def knn_select(scores, doc_ids, k: int):
    """Stable top-k of (B, N) scores, any 1 <= k <= N: (vals (B, k) f32,
    ids (B, k) int32)."""
    if not dispatch.is_kernel(scores):
        return ref.select(scores, doc_ids, k)
    b, n = scores.shape
    dev = scores.device
    if not 1 <= k <= n:
        raise ValueError(f"k={k} outside [1, N={n}]")
    if n >= 2 ** 31 - 1:
        raise ValueError(f"row of {n} scores exceeds int32 positions")
    if b > MAX_ROWS:
        raise ValueError(f"{b} rows exceed the select grid's {MAX_ROWS}")
    _check(doc_ids, "doc_ids", torch.int32, (n,), dev)
    scores = scores.contiguous()
    cap, bufcap, words = _select_words(n, k)
    scratch = torch.empty(b * words, dtype=torch.int32, device=dev)
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    ids = torch.empty((b, k), dtype=torch.int32, device=dev)
    fn = _build.function("knn", "knn_select", _SELECT_ARGS)
    SELECT.launch()
    code = fn(scores.data_ptr(), doc_ids.contiguous().data_ptr(),
              scratch.data_ptr(), vals.data_ptr(), ids.data_ptr(), b, n, k,
              cap, bufcap, int(cap > _build.SMEM_PAIRS),
              _build.stream_of(scores))
    _build.check(code, "knn_select")
    return vals, ids


@dispatch.kernel_extent
def knn_tile_topk(docs, doc_ids, queries, k_eff: int, tile_n: int,
                  scale=None, q_scale=None):
    """Per-tile stable top ``k_eff`` of the masked scores, the corpus read
    as padded to a ``tile_n`` multiple: (vals (tiles, B, k_eff) f32,
    positions (tiles, B, k_eff) int32), each the permuted view of a (B,
    tiles, k_eff) buffer.  Queries at the corpus width (int8 payload with
    ``q_scale`` under int8-dot).  One launch of the fused kernel, which
    takes tiles of at most ``FUSED_MAX_TILE`` (the plain version any).  A
    position whose value is -inf may be any masked or padded one."""
    if not dispatch.is_kernel(docs):
        return ref.tile_topk(docs, doc_ids, queries, k_eff, tile_n, scale,
                             q_scale)
    n, dp = docs.shape
    b = queries.shape[0]
    if not 1 <= k_eff <= tile_n:
        raise ValueError(f"k_eff={k_eff} outside [1, tile_n={tile_n}]")
    if tile_n > FUSED_MAX_TILE:
        raise ValueError(f"tile_n={tile_n} exceeds the fused tile kernel's "
                         f"{FUSED_MAX_TILE}")
    if b > MAX_ROWS:
        raise ValueError(f"{b} queries exceed the tile grid's {MAX_ROWS} "
                         f"rows")
    if n + tile_n >= 2 ** 31:
        raise ValueError(f"corpus of {n} rows in tiles of {tile_n} exceeds "
                         f"int32 positions")
    docs, doc_ids, queries, scale, i8 = _operands(docs, doc_ids, queries,
                                                  scale, q_scale)
    tiles = -(-n // tile_n)
    vals = torch.empty((b, tiles, k_eff), dtype=torch.float32,
                       device=docs.device)
    pos = torch.empty((b, tiles, k_eff), dtype=torch.int32,
                      device=docs.device)
    fn = _build.function("knn", "knn_tile_topk", _TILE_ARGS)
    TILE.launch()
    code = fn(queries.data_ptr(), q_scale.data_ptr() if i8 else None,
              docs.data_ptr(), doc_ids.data_ptr(), _ptr(scale),
              vals.data_ptr(), pos.data_ptr(), b, n, dp,
              _build.STORE[docs.dtype], int(i8), tile_n, k_eff,
              _build.stream_of(docs))
    _build.check(code, "knn_tile_topk")
    return vals.permute(1, 0, 2), pos.permute(1, 0, 2)


def merge_tiles(vals, pos, doc_ids, k: int):
    """The two-stage merge through ``knn_select``: the stable top-k of the
    (tiles, B, k_eff) candidates in tile-major order (the lower candidate
    index wins a tie: the lower tile, then the lower position, as
    ``lax.top_k`` orders them), each result's corpus position gathered and
    mapped to ``doc_ids``, -1 where the score is -inf or the position past
    N.  An int32 ``arange`` carries the candidate index through the
    select.  Equals ``ref.merge_tiles`` bit for bit."""
    tiles, b, ke = vals.shape
    v = vals.permute(1, 0, 2).reshape(b, tiles * ke)
    p = pos.permute(1, 0, 2).reshape(b, tiles * ke)
    cand = torch.arange(tiles * ke, dtype=torch.int32, device=v.device)
    top_s, top_c = knn_select(v, cand, k)
    top_p = torch.gather(p, 1, top_c.clamp(min=0).long())
    n = doc_ids.shape[0]
    found = doc_ids[top_p.clamp(0, n - 1).long()]
    top_i = torch.where(torch.isneginf(top_s) | (top_p >= n),
                        torch.tensor(-1, dtype=doc_ids.dtype,
                                     device=doc_ids.device), found)
    return top_s, top_i


@dispatch.kernel_extent
def knn_search(docs: torch.Tensor, doc_ids: torch.Tensor,
               queries: torch.Tensor, k: int,
               scale: torch.Tensor | None = None,
               int8_dot: bool | None = None,
               tile_n: int | None = None, two_stage: bool = False):
    """Top-k MIPS.  docs (N, Dp) fp32 / bf16 / int8 payload with ``scale``
    its (N,) f32 per-document multiplier (None = unquantized); doc_ids (N,)
    int32, -1 on sentinel rows; queries (B, d <= Dp) f32, any B (answered
    in chunks of ``chunk_rows``).  ``int8_dot`` (None = the
    ``REPRO_INT8_DOT`` policy, int8 corpora only) scores int8 x int8 in
    int32.  ``two_stage`` takes the per-tile scan with ``tile_n`` (None =
    ``autotune_knn`` for the whole B), which raises when its tiles * k_eff
    candidates cannot hold k; a tile over ``FUSED_MAX_TILE`` answers
    through the fused search.  Returns (scores (B, k) descending, ids
    (B, k), -1 where the score is -inf)."""
    n, dp = docs.shape
    q = torch.nn.functional.pad(queries.to(torch.float32),
                                (0, dp - queries.shape[1]))
    q_scale = None
    if quant.resolve_int8_dot(int8_dot, docs.dtype):
        qq = quant.quantize(q, "int8")
        q, q_scale = qq.data, qq.scale
    b = q.shape[0]
    if two_stage:
        if tile_n is None:
            tile_n, k_eff = autotune_knn(n, dp, b, k, docs.element_size())
        else:
            tile_n = min(tile_n, max(SUBLANE, layout.next_pow2(n)))
            k_eff = min(k, tile_n)
        tiles = -(-n // tile_n)
        if tiles * k_eff < k:
            raise ValueError(f"two-stage candidate pool {tiles}x{k_eff} < "
                             f"k={k}; use the fused search")
    # a wider tile keeps its whole share of the top k: the fused answer
    if two_stage and tile_n <= FUSED_MAX_TILE:
        TILE.call()
        SELECT.call()

        def chunk(lo, hi):
            vals, pos = knn_tile_topk(docs, doc_ids, q[lo:hi], k_eff, tile_n,
                                      scale, _rows(q_scale, lo, hi))
            return merge_tiles(vals, pos, doc_ids, k)
        return _chunked(chunk, b, k, two_stage_rows(n, tile_n, k_eff, k),
                        q.device)
    SCORE.call()
    SELECT.call()
    gemv = b <= SCORE_GEMV_MAX_B     # the whole B's path, for every chunk
    k_eff = min(k, n)

    def chunk(lo, hi):
        qs = _rows(q_scale, lo, hi)
        if not dispatch.is_kernel(docs):
            return ref.search(docs, doc_ids, q[lo:hi], k, scale, qs)
        vals, ids = knn_select(_score(docs, doc_ids, q[lo:hi], scale, qs,
                                      gemv=gemv), doc_ids, k_eff)
        if k_eff < k:
            vals = torch.nn.functional.pad(vals, (0, k - k_eff),
                                           value=float("-inf"))
            ids = torch.nn.functional.pad(ids, (0, k - k_eff), value=-1)
        return vals, ids
    return _chunked(chunk, b, k, chunk_rows(n, 4 * _select_words(n, k_eff)[2]),
                    q.device)


def _rows(t, lo: int, hi: int):
    return None if t is None else t[lo:hi]


def _chunked(chunk, b: int, k: int, rows: int, device):
    """``chunk(lo, hi)`` over [0, b) in steps of ``rows``: its (scores,
    ids), written into the (B, k) answer when there is more than one."""
    if b <= rows:
        return chunk(0, b)
    vals = torch.empty((b, k), dtype=torch.float32, device=device)
    ids = torch.empty((b, k), dtype=torch.int32, device=device)
    for lo in range(0, b, rows):
        v, i = chunk(lo, min(lo + rows, b))
        vals[lo:lo + rows].copy_(v)
        ids[lo:lo + rows].copy_(i)
        del v, i
    return vals, ids
