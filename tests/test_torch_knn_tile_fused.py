"""The port's fused two-stage tile stage and its merge against the JAX
package, on the CPU.

The same numpy corpus and queries go through JAX ``knn_tile_topk`` (the
Pallas kernel in interpret mode) and ``knn_search(two_stage=True)``, and
through the port's ``knn_tile_topk`` and ``knn_search(two_stage=True)`` on
CPU tensors (``ref.tile_topk``, the plain version beside the fused CUDA
kernel, then ``merge_tiles`` through ``knn_select``).  Tiles of 8, 16, 24,
100, 256 and 512 (at least N), k_eff at the tile and below it, exact ties
inside a tile and across tiles, id -1 rows, N not a tile multiple, and
fp32 / bf16 / int8 / int8-dot.  Ids, positions where the value is finite
and the -inf pattern are equal; scores agree within 1e-5.  Also: the merge
through the select equals the plain stable sort bit for bit, the tile
stage's (tiles, B, k_eff) view, the launch accounting, a tile wider than
``FUSED_MAX_TILE`` answering as the fused search, and ``two_stage_rows``
(a chunk's candidates and merge scratch fit ``SCRATCH_BUDGET``, in whole
64-query tiles).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.kernels.knn.knn import knn_tile_topk as jtile_topk
from repro.kernels.knn.ops import knn_search as jknn_search
from repro_torch import convert
from repro_torch.kernels import dispatch
from repro_torch.kernels.knn import ops as knn_ops
from repro_torch.kernels.knn import ref as knn_ref

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-5
N, DIM, B = 230, 128, 3
DTYPES = [("fp32", False), ("bf16", False), ("int8", False), ("int8", True)]
# (tile_n, k_eff): k_eff at the tile and below it; 512 is a tile past N
TILES = [(8, 8), (8, 3), (16, 16), (16, 5), (24, 24), (24, 7), (100, 100),
         (100, 30), (256, 256), (256, 40), (512, 512), (512, 100)]


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _world(seed, dtype, n=N):
    """A corpus with exact ties inside the first tiles (rows 2, 3 and 5 as
    row 1) and across tiles (rows 40, 130 and 201 as row 1), query 0 next to
    them, and id -1 rows inside and at the end."""
    rng = np.random.default_rng(seed)
    docs = _unit(rng.standard_normal((n, DIM))).astype(np.float32)
    docs[[2, 3, 5, 40, 130, 201]] = docs[1]
    q = _unit(rng.standard_normal((B, DIM))).astype(np.float32)
    q[0] = _unit(docs[1] + 0.1 * rng.standard_normal(DIM)).astype(np.float32)
    ids = np.arange(n, dtype=np.int32) + 100
    ids[[4, 72, n - 2, n - 1]] = -1
    qc = jquant.quantize(jnp.asarray(docs), dtype)
    scale = None if qc.scale is None else np.array(qc.scale)
    return np.array(qc.data), scale, ids, q


def _queries(q, int8_dot):
    """The queries as both tile stages take them: f32, or the JAX int8
    payload and its per-row scale under int8-dot."""
    if not int8_dot:
        return q, None
    qq = jquant.quantize(jnp.asarray(q), "int8")
    return np.array(qq.data), np.array(qq.scale)


def _jax_tiles(data, scale, ids, qd, qs, k_eff, tile_n, int8_dot):
    """JAX ``knn_tile_topk`` over the corpus padded to a tile multiple with
    id -1 rows, as its wrapper pads it."""
    pad = -len(ids) % tile_n
    data_p = np.concatenate([data, np.zeros((pad, DIM), data.dtype)])
    ids_p = np.concatenate([ids, np.full(pad, -1, np.int32)])
    scale_p = None if scale is None else jnp.asarray(
        np.concatenate([scale, np.ones(pad, np.float32)]))
    vals, pos = jtile_topk(jnp.asarray(data_p), jnp.asarray(ids_p),
                           jnp.asarray(qd), k_eff, tile_n=tile_n,
                           interpret=True, scale=scale_p,
                           q_scale=None if qs is None else jnp.asarray(qs),
                           int8_dot=int8_dot)
    return np.asarray(vals), np.asarray(pos)


def _assert_tiles_equal(port, ref):
    pv, pp = (x.numpy() for x in port)
    rv, rp = ref
    assert pv.shape == rv.shape
    np.testing.assert_array_equal(np.isneginf(pv), np.isneginf(rv))
    fin = np.isfinite(rv)
    np.testing.assert_allclose(pv[fin], rv[fin], atol=TOL, rtol=0)
    np.testing.assert_array_equal(pp[fin], rp[fin])


@pytest.mark.parametrize("dtype,int8_dot", DTYPES)
@pytest.mark.parametrize("tile_n,k_eff", TILES)
def test_tile_stage_matches_jax(dtype, int8_dot, tile_n, k_eff):
    data, scale, ids, q = _world(1, dtype)
    qd, qs = _queries(q, int8_dot)
    ref = _jax_tiles(data, scale, ids, qd, qs, k_eff, tile_n, int8_dot)
    docs, tscale, tids = convert.corpus_from_numpy(data, scale, ids,
                                                   device="cpu")
    port = knn_ops.knn_tile_topk(
        docs, tids, torch.as_tensor(qd), k_eff, tile_n, tscale,
        None if qs is None else torch.as_tensor(qs))
    _assert_tiles_equal(port, ref)
    # the tied rows lead query 0's tiles in position order
    pv, pp = (x.numpy() for x in port)
    first = pp[0, 0, :min(k_eff, 4)].tolist()
    assert first == [1, 2, 3, 5][:len(first)] or tile_n < 8


@pytest.mark.parametrize("dtype,int8_dot", DTYPES)
@pytest.mark.parametrize("k,tile_n", [(30, 8), (10, 16), (50, 24), (20, 100),
                                      (150, 100), (60, 256), (40, 512)])
def test_two_stage_search_matches_jax(dtype, int8_dot, k, tile_n):
    """The whole search: ids equal, the -inf pattern equal, scores within
    1e-5; one fused tile call and one merge select, no score call."""
    data, scale, ids, q = _world(2, dtype)
    jscale = None if scale is None else jnp.asarray(scale)
    ref = jknn_search(jnp.asarray(data), jnp.asarray(ids), jnp.asarray(q), k,
                      tile_n=tile_n, backend="interpret", two_stage=True,
                      scale=jscale, int8_dot=int8_dot)
    docs, tscale, tids = convert.corpus_from_numpy(data, scale, ids,
                                                   device="cpu")
    dispatch.reset_counters()
    port = knn_ops.knn_search(docs, tids, torch.as_tensor(q), k,
                              scale=tscale, int8_dot=int8_dot,
                              tile_n=tile_n, two_stage=True)
    c = dispatch.counters()
    assert (c["knn_tile_topk"].calls, c["knn_select"].calls,
            c["knn_score"].calls) == (1, 1, 0)
    ps, pi = (x.numpy() for x in port)
    rs, ri = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_array_equal(np.isneginf(ps), np.isneginf(rs))
    fin = np.isfinite(rs)
    np.testing.assert_allclose(ps[fin], rs[fin], atol=TOL, rtol=0)
    assert not np.isin([104, 172, 328, 329], pi).any()


def _candidates(seed, tiles, b, ke, n):
    """Per-tile candidate lists as the tile stage writes them: descending
    values with a value shared by several tiles, -inf runs, and positions
    past N."""
    g = torch.Generator().manual_seed(seed)
    vals = torch.randn(b, tiles, ke, generator=g)
    vals[:, 3:9, 10:20] = 0.5
    vals[1, :, 30:] = float("-inf")
    vals[2, 20:] = float("-inf")
    vals = torch.sort(vals, dim=2, descending=True).values
    pos = torch.randint(0, n + 100, (b, tiles, ke), generator=g,
                        dtype=torch.int32)
    return vals.permute(1, 0, 2), pos.permute(1, 0, 2)


@pytest.mark.parametrize("k", [1, 100, 700, 2560])
def test_merge_through_select_equals_plain(k):
    """``ops.merge_tiles`` (the select over the tile-major candidates, the
    corpus position gathered) equals ``ref.merge_tiles`` (a stable sort)
    bit for bit: the lower tile, then the lower rank, wins a tie."""
    tiles, b, ke, n = 40, 5, 64, 2500
    vals, pos = _candidates(4, tiles, b, ke, n)
    ids = torch.arange(n, dtype=torch.int32) + 7
    ids[::11] = -1
    got = knn_ops.merge_tiles(vals, pos, ids, k)
    want = knn_ref.merge_tiles(vals, pos, ids, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_tile_stage_returns_a_view_of_the_row_major_buffer():
    """(tiles, B, k_eff) views of one (B, tiles, k_eff) buffer, each (tile,
    row) the stable top k_eff of that tile's scores."""
    data, scale, ids, q = _world(3, "fp32")
    docs, _, tids = convert.corpus_from_numpy(data, None, ids, device="cpu")
    tq = torch.as_tensor(q)
    vals, pos = knn_ops.knn_tile_topk(docs, tids, tq, 10, 24)
    tiles = -(-N // 24)
    assert vals.shape == pos.shape == (tiles, B, 10)
    assert vals.permute(1, 0, 2).is_contiguous()
    assert pos.permute(1, 0, 2).is_contiguous() and pos.dtype == torch.int32
    s = knn_ref.score(docs, tids, tq)
    for t in (0, 5, tiles - 1):
        seg = torch.nn.functional.pad(s[:, t * 24:(t + 1) * 24],
                                      (0, 24 - s[:, t * 24:].shape[1]
                                       if t == tiles - 1 else 0),
                                      value=float("-inf"))
        v, p = torch.sort(seg, dim=1, descending=True, stable=True)
        assert torch.equal(vals[t], v[:, :10])
        fin = torch.isfinite(v[:, :10])
        assert torch.equal(pos[t][fin], (p[:, :10] + 24 * t)[fin].int())


def test_wide_tiles_keep_the_pair():
    """A tile wider than ``FUSED_MAX_TILE`` keeps its whole share of the
    top k, so the search answers through the fused search: one score call
    and one select call, no tile call; the answer equals the plain
    two-stage version bit for bit."""
    rng = np.random.default_rng(5)
    n = 9000
    docs = torch.as_tensor(_unit(rng.standard_normal((n, 32)))
                           .astype(np.float32))
    ids = torch.arange(n, dtype=torch.int32)
    q = torch.as_tensor(_unit(rng.standard_normal((2, 32)))
                        .astype(np.float32))
    dispatch.reset_counters()
    v, i = knn_ops.knn_search(docs, ids, q, 10, tile_n=8192, two_stage=True)
    c = dispatch.counters()
    assert (c["knn_score"].calls, c["knn_select"].calls,
            c["knn_tile_topk"].calls) == (1, 1, 0)
    rv, rp = knn_ref.tile_topk(docs, ids, q, 10, 8192)
    want = knn_ref.merge_tiles(rv, rp, ids, 10)
    assert torch.equal(v, want[0]) and torch.equal(i, want[1])


@pytest.mark.parametrize("dtype,int8_dot", DTYPES)
def test_wide_tiles_answer_as_the_fused_search(dtype, int8_dot):
    """``two_stage=True`` at a tile over ``FUSED_MAX_TILE`` equals the fused
    search bit for bit, at k past N too (ties, id -1 rows), and raises
    where the tiles' candidates cannot hold k."""
    n = 5000
    data, scale, ids, q = _world(7, dtype, n=n)
    docs, tscale, tids = convert.corpus_from_numpy(data, scale, ids,
                                                   device="cpu")
    tq = torch.as_tensor(q)
    for k in (10, 8192):
        got = knn_ops.knn_search(docs, tids, tq, k, scale=tscale,
                                 int8_dot=int8_dot, tile_n=8192,
                                 two_stage=True)
        want = knn_ops.knn_search(docs, tids, tq, k, scale=tscale,
                                  int8_dot=int8_dot)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="candidate pool"):
        knn_ops.knn_search(docs, tids, tq, 8193, scale=tscale,
                           int8_dot=int8_dot, tile_n=8192, two_stage=True)


@pytest.mark.parametrize("n,tile_n,k", [(8_841_823, 512, 1000),
                                        (1_000_000, 1024, 1000),
                                        (60_000, 4096, 200), (5000, 16, 100),
                                        (200_000_000, 512, 1000),
                                        (1_048_576, 256, 100)])
def test_two_stage_rows_fit_the_budget_in_whole_tiles(n, tile_n, k):
    """A chunk's candidates (value and position) and the merge's select
    scratch fit ``SCRATCH_BUDGET``, in whole 64-query tiles.  One tile is
    the floor, even past the budget: at the A/B shape one chunk of 64
    holds more than 4 GiB."""
    tile, budget = knn_ops.QUERY_TILE, knn_ops.SCRATCH_BUDGET
    k_eff = min(k, tile_n)
    cands = -(-n // tile_n) * k_eff
    row = 8 * cands + 4 * knn_ops._select_words(cands, k)[2]
    rows = knn_ops.two_stage_rows(n, tile_n, k_eff, k)
    assert rows % tile == 0 and tile <= rows <= knn_ops.MAX_ROWS
    assert rows == tile or rows * row <= budget
    assert rows == knn_ops.MAX_ROWS // tile * tile or \
        (rows + tile) * row > budget
    if n == 8_841_823:
        assert rows == 64 and rows * row > budget


def test_two_stage_chunks_follow_two_stage_rows(monkeypatch):
    """A budget that holds exactly 128 queries of this two-stage search
    chunks 200 queries as 128 + 72, and the answer equals the unchunked."""
    rng = np.random.default_rng(6)
    n, k, tile_n = 3000, 20, 64
    docs = torch.as_tensor(_unit(rng.standard_normal((n, 32)))
                           .astype(np.float32))
    ids = torch.arange(n, dtype=torch.int32)
    q = torch.as_tensor(_unit(rng.standard_normal((200, 32)))
                        .astype(np.float32))
    whole = knn_ops.knn_search(docs, ids, q, k, tile_n=tile_n, two_stage=True)
    cands = -(-n // tile_n) * k
    row = 8 * cands + 4 * knn_ops._select_words(cands, k)[2]
    monkeypatch.setattr(knn_ops, "SCRATCH_BUDGET", 128 * row)
    assert knn_ops.two_stage_rows(n, tile_n, k, k) == 128
    sizes = []
    merge = knn_ops.merge_tiles

    def recorded(vals, pos, doc_ids, k):
        sizes.append(vals.shape[1])
        return merge(vals, pos, doc_ids, k)
    monkeypatch.setattr(knn_ops, "merge_tiles", recorded)
    parts = knn_ops.knn_search(docs, ids, q, k, tile_n=tile_n, two_stage=True)
    assert sizes == [128, 72]
    assert torch.equal(parts[0], whole[0]) and torch.equal(parts[1], whole[1])
