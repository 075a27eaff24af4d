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
  * ``two_stage=True`` — ``knn_tile_topk``: ``knn_score``, then the stable
    top ``k_eff = min(k, tile_n)`` positions of every ``tile_n`` tile
    (``knn_tile_select``), then the merge here in the wrapper: the stable
    top-k of the tile-major candidates, -inf results taking id -1.  The
    corpus counts as padded to a tile multiple with id -1 rows (the kernel
    reads positions past N as -inf; nothing is copied).  When
    ``k_eff < k`` the answer can differ from the exact top-k: it is the
    JAX package's two-stage answer for the same ``tile_n``.
    ``autotune_knn`` is the JAX tuner's arithmetic, so the default
    ``tile_n`` and ``k_eff`` equal the JAX ones.

On a CUDA tensor the kernels launch; on a CPU tensor the plain versions in
``ref`` run.  Every scratch buffer of the kernels (the select's
histograms, counters, candidates and filter buffers) is allocated here.

The scratch is bounded: ``knn_search`` answers the queries in chunks of
``chunk_rows`` rows, a multiple of the score GEMM's ``QUERY_TILE``, sized
so that one chunk's (B_c, N) f32 scores and select scratch fit
``SCRATCH_BUDGET`` bytes; both devices chunk alike.  Rows are independent,
and every chunk takes the score path that the whole B chooses (a tail of
<= ``SCORE_GEMV_MAX_B`` queries stays on the GEMM), so the answers equal the
unchunked search's bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import layout, quant
from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.knn import ref

__all__ = ["knn_score", "knn_select", "knn_tile_topk", "knn_tile_select",
           "knn_search", "chunk_rows",
           "autotune_knn", "SCORE", "SELECT", "TILE", "SCORE_GEMV_MAX_B",
           "SCRATCH_BUDGET", "QUERY_TILE"]

SCORE = dispatch.counter("knn_score")
SELECT = dispatch.counter("knn_select")
TILE = dispatch.counter("knn_tile_topk")
# the JAX tuner's padding rules (TPU lane and sublane), kept so that
# ``autotune_knn`` picks the JAX package's tile for the same call
LANE, SUBLANE = 128, 8
# the largest B that takes the single-query score path, and the widest
# query block of the kernel's GEMV (measured crossover: PERF.md)
SCORE_GEMV_MAX_B = 8
SELECT_WS = 2 * 4096 + 16 + 256  # csrc/knn.cu WS_ROW
SELECT_BUF = 1 << 16      # filter buffer per row (keys at the k-th digit)
# bytes one chunk of a search may hold in scratch: its (B_c, N) f32 scores
# and select scratch (64 queries over the 8,841,823-doc corpus take 2.3 GB)
SCRATCH_BUDGET = 4 << 30
# the score GEMM's query tile (csrc/knn.cu), the plain scores' block too
QUERY_TILE = ref.QUERY_BLOCK
MAX_ROWS = 65535          # the select and tile grids' row limit
_SCORE_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong]
               + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_SELECT_ARGS = ([ctypes.c_void_p] * 5
                + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
_TILE_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong]
              + [ctypes.c_int] * 3 + [ctypes.c_void_p])


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
    cap = max(SUBLANE, 1 << max(n - 1, 1).bit_length())
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


def knn_score(docs, doc_ids, queries, scale=None, q_scale=None):
    """Masked (B, N) f32 scores; ``q_scale`` given means int8-dot queries."""
    b = queries.shape[0]
    return _score(docs, doc_ids, queries, scale, q_scale,
                  gemv=b <= SCORE_GEMV_MAX_B)


def _score(docs, doc_ids, queries, scale, q_scale, *, gemv: bool):
    """``knn_score`` on the path asked for: the single-query GEMV
    (B <= ``SCORE_GEMV_MAX_B``) or the batched GEMM (any B)."""
    if not dispatch.is_kernel(docs):
        return ref.score(docs, doc_ids, queries, scale, q_scale)
    n, dp = docs.shape
    b = queries.shape[0]
    dev = docs.device
    if docs.dtype not in _build.STORE:
        raise TypeError(f"unsupported corpus dtype {docs.dtype}")
    if dp % layout.FEAT:       # the score kernel's feature tile (GK)
        raise ValueError(f"corpus width {dp} is not a multiple of "
                         f"{layout.FEAT}")
    if n >= 2 ** 31:
        raise ValueError(f"corpus of {n} rows exceeds int32 positions")
    if gemv and b > SCORE_GEMV_MAX_B:
        raise ValueError(f"the single-query path takes at most "
                         f"{SCORE_GEMV_MAX_B} queries, got {b}")
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
    _check_aligned(docs, "docs")
    _check_aligned(queries, "queries")
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    fn = _build.function("knn", "knn_score", _SCORE_ARGS)
    SCORE.launch()
    code = fn(queries.data_ptr(), q_scale.data_ptr() if i8 else None,
              docs.data_ptr(), doc_ids.data_ptr(),
              None if scale is None else scale.contiguous().data_ptr(),
              out.data_ptr(), b, n, dp, _build.STORE[docs.dtype],
              int(i8), int(gemv), _build.stream_of(docs))
    _build.check(code, "knn_score")
    return out


def _select_words(n: int, k: int) -> tuple[int, int, int]:
    """(cap, bufcap, int32 words of scratch per row) of a select of the top
    ``k`` of ``n``: every key above the k-th plus its tie run, up to cap;
    the workspace (histograms, counters), candidates and filter buffers."""
    cap = 2 << (k - 1).bit_length()
    bufcap = min(n, SELECT_BUF)
    return cap, bufcap, SELECT_WS + 2 * cap + 4 * bufcap


def chunk_rows(n: int, row_bytes: int) -> int:
    """Queries per chunk of a search over ``n`` documents when a query row
    needs ``row_bytes`` of scratch besides its f32 scores: the most that
    fit ``SCRATCH_BUDGET``, in whole ``QUERY_TILE``s (at least one), and
    never more than the grids' row limit."""
    rows = SCRATCH_BUDGET // (4 * n + row_bytes) // QUERY_TILE * QUERY_TILE
    return min(max(rows, QUERY_TILE), MAX_ROWS // QUERY_TILE * QUERY_TILE)


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


def knn_tile_topk(docs, doc_ids, queries, k_eff: int, tile_n: int,
                  scale=None, q_scale=None, gemv: bool | None = None):
    """Per-tile stable top ``k_eff`` of the masked scores, the corpus read
    as padded to a ``tile_n`` multiple: (vals (tiles, B, k_eff) f32,
    positions (tiles, B, k_eff) int32).  Queries at the corpus width (int8
    payload with ``q_scale`` under int8-dot); ``gemv`` the score path (None:
    the one these B queries choose).  A position whose value is -inf may be
    any masked or padded one."""
    if not dispatch.is_kernel(docs):
        return ref.tile_topk(docs, doc_ids, queries, k_eff, tile_n, scale,
                             q_scale)
    n = docs.shape[0]
    b = queries.shape[0]
    if not 1 <= k_eff <= tile_n:
        raise ValueError(f"k_eff={k_eff} outside [1, tile_n={tile_n}]")
    if b > MAX_ROWS:
        raise ValueError(f"{b} queries exceed the tile grid's {MAX_ROWS} "
                         f"rows")
    if gemv is None:
        gemv = b <= SCORE_GEMV_MAX_B
    return knn_tile_select(_score(docs, doc_ids, queries, scale, q_scale,
                                  gemv=gemv), k_eff, tile_n)


def knn_tile_select(scores, k_eff: int, tile_n: int):
    """The select stage of ``knn_tile_topk`` on (B, N) f32 scores already
    computed (the launch it counts): (vals, positions), each (tiles, B,
    k_eff).  CUDA only."""
    b, n = scores.shape
    dev = scores.device
    tiles = -(-n // tile_n)
    vals = torch.empty((tiles, b, k_eff), dtype=torch.float32, device=dev)
    pos = torch.empty((tiles, b, k_eff), dtype=torch.int32, device=dev)
    kp, pair_key, pair_pos = _build.pair_scratch(tiles * b, k_eff, dev)
    fn = _build.function("knn", "knn_tile_select", _TILE_ARGS)
    TILE.launch()
    code = fn(scores.contiguous().data_ptr(), vals.data_ptr(), pos.data_ptr(),
              _ptr(pair_key), _ptr(pair_pos), b, n, tile_n, k_eff, kp,
              _build.stream_of(scores))
    _build.check(code, "knn_tile_select")
    return vals, pos


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
    candidates cannot hold k.  Returns (scores (B, k) descending, ids
    (B, k), -1 where the score is -inf)."""
    n, dp = docs.shape
    q = torch.nn.functional.pad(queries.to(torch.float32),
                                (0, dp - queries.shape[1]))
    q_scale = None
    if quant.resolve_int8_dot(int8_dot, docs.dtype):
        qq = quant.quantize(q, "int8")
        q, q_scale = qq.data, qq.scale
    b = q.shape[0]
    gemv = b <= SCORE_GEMV_MAX_B     # the whole B's path, for every chunk
    if two_stage:
        SCORE.call()
        TILE.call()
        if tile_n is None:
            tile_n, k_eff = autotune_knn(n, dp, b, k, docs.element_size())
        else:
            tile_n = min(tile_n, max(SUBLANE, 1 << max(n - 1, 1).bit_length()))
            k_eff = min(k, tile_n)
        tiles = -(-n // tile_n)
        if tiles * k_eff < k:
            raise ValueError(f"two-stage candidate pool {tiles}x{k_eff} < "
                             f"k={k}; use the fused search")

        def chunk(lo, hi):
            vals, pos = knn_tile_topk(docs, doc_ids, q[lo:hi], k_eff, tile_n,
                                      scale, _rows(q_scale, lo, hi), gemv)
            return ref.merge_tiles(vals, pos, doc_ids, k)
        return _chunked(chunk, b, k, chunk_rows(n, 8 * tiles * k_eff),
                        q.device)
    SCORE.call()
    SELECT.call()
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
