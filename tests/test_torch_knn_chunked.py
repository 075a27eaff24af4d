"""The kNN search in chunks of queries under a scratch budget, on the CPU.

``knn_search`` answers B queries in chunks of ``chunk_rows`` rows so that
one chunk's (B_c, N) f32 scores and select scratch fit
``SCRATCH_BUDGET``.  Rows are independent, so a search forced into several
chunks (the budget shrunk with ``monkeypatch``), a tail chunk of <= 8
queries among them, must equal the unchunked search bit for bit under every
storage dtype and the int8-dot rule, fused and two-stage; and
``MetricIndex.search`` must answer as the JAX package does (ids equal,
scores within 1e-6, as ``test_torch_metric_index.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metric_index as jmi
from repro.data.conversations import WorldConfig, make_world
from repro_torch.core import metric_index as tmi
from repro_torch.core import quant
from repro_torch.kernels.knn import ops as knn_ops

jax.config.update("jax_platform_name", "cpu")

# 14 conversations x 5 turns = 70 queries: one 64-query tile and a tail of 6
WORLD = WorldConfig(n_topics=4, docs_per_topic=300, n_background=800, dim=40,
                    subspace_dim=6, turns=5, n_conversations=14, seed=9)
DTYPES = [("fp32", False), ("bf16", False), ("int8", False), ("int8", True)]
K = 30


@pytest.fixture(scope="module")
def world():
    return make_world(WORLD)


def _queries(world):
    return np.concatenate([c.queries for c in world.conversations]) \
        .astype(np.float32)


def _index(world, dtype, int8_dot):
    return tmi.MetricIndex(world.doc_emb.astype(np.float32), dtype=dtype,
                           int8_dot=int8_dot, device="cpu")


def _shrink(monkeypatch, ix, rows):
    """A budget that holds exactly ``rows`` queries of this search."""
    n = ix.doc_emb.shape[0]
    words = knn_ops._select_words(n, min(K, n))[2]
    monkeypatch.setattr(knn_ops, "SCRATCH_BUDGET",
                        rows * (4 * n + 4 * words))
    assert knn_ops.chunk_rows(n, 4 * words) == rows


def _record_chunks(monkeypatch):
    sizes = []
    search = knn_ops.ref.search

    def recorded(docs, doc_ids, queries, *args):
        sizes.append(queries.shape[0])
        return search(docs, doc_ids, queries, *args)
    monkeypatch.setattr(knn_ops.ref, "search", recorded)
    return sizes


def test_chunk_rows_fits_the_budget_in_whole_tiles():
    tile, budget = knn_ops.QUERY_TILE, knn_ops.SCRATCH_BUDGET
    row = 4 * knn_ops._select_words(8_841_823, 1000)[2]
    # the full corpus: one 64-query tile a chunk, 2,048 queries in 32
    assert knn_ops.chunk_rows(8_841_823, row) == 64
    for n in (10, 1000, 60_000, 1_000_000, 8_841_823, 200_000_000):
        rows = knn_ops.chunk_rows(n, row)
        assert rows % tile == 0 and tile <= rows <= knn_ops.MAX_ROWS
        assert rows == tile or rows * (4 * n + row) <= budget


@pytest.mark.parametrize("dtype,int8_dot", DTYPES)
@pytest.mark.parametrize("b,rows", [(70, 64), (134, 64), (134, 128)])
def test_chunked_search_equals_unchunked_bit_for_bit(world, monkeypatch,
                                                     dtype, int8_dot, b,
                                                     rows):
    ix = _index(world, dtype, int8_dot)
    q = _queries(world)
    q = ix.transform_queries(torch.as_tensor(np.concatenate([q, q])[:b]))
    whole = ix.search(q, K)
    _shrink(monkeypatch, ix, rows)
    sizes = _record_chunks(monkeypatch)
    parts = ix.search(q, K)
    tail = b % rows
    assert sizes == [rows] * (b // rows) + [tail] and tail <= 8
    for f in ("scores", "distances", "ids"):
        assert torch.equal(getattr(parts, f), getattr(whole, f)), f


@pytest.mark.parametrize("dtype,int8_dot", DTYPES)
def test_chunked_search_matches_jax(world, monkeypatch, dtype, int8_dot):
    ix = _index(world, dtype, int8_dot)
    ref_ix = jmi.MetricIndex(jnp.asarray(world.doc_emb.astype(np.float32)),
                             use_kernel=False, dtype=dtype, int8_dot=int8_dot)
    q = _queries(world)
    _shrink(monkeypatch, ix, 64)
    port = ix.search(ix.transform_queries(torch.as_tensor(q)), K)
    ref = ref_ix.search(ref_ix.transform_queries(jnp.asarray(q)), K)
    np.testing.assert_array_equal(port.ids.numpy(), np.asarray(ref.ids))
    np.testing.assert_allclose(port.scores.numpy(), np.asarray(ref.scores),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype,int8_dot", [("fp32", False), ("int8", True)])
def test_two_stage_search_chunks_too(world, monkeypatch, dtype, int8_dot):
    """The two-stage scan takes its tile from the whole B and chunks the
    queries as the fused one does: the same answer in chunks."""
    ix = _index(world, dtype, int8_dot)
    q = ix.transform_queries(torch.as_tensor(_queries(world)))
    kw = dict(scale=ix.doc_scale, int8_dot=int8_dot, two_stage=True)
    whole = knn_ops.knn_search(ix.doc_emb, ix.doc_ids, q, K, **kw)
    n = ix.doc_emb.shape[0]
    monkeypatch.setattr(knn_ops, "SCRATCH_BUDGET", 64 * 4 * n)
    merged = []
    merge = knn_ops.merge_tiles

    def recorded(vals, pos, doc_ids, k):
        merged.append(vals.shape[1])
        return merge(vals, pos, doc_ids, k)
    monkeypatch.setattr(knn_ops, "merge_tiles", recorded)
    parts = knn_ops.knn_search(ix.doc_emb, ix.doc_ids, q, K, **kw)
    assert merged == [64, 6]
    assert torch.equal(parts[0], whole[0]) and torch.equal(parts[1], whole[1])


def test_plain_int8_dot_scores_per_block():
    """Under int8-dot the plain scores sum exactly (f64 per 64-query block)
    and scale as (f32(acc) * q_scale) * scale: a block boundary changes
    nothing."""
    rng = np.random.default_rng(3)
    docs = quant.quantize(torch.as_tensor(
        rng.standard_normal((300, 64)).astype(np.float32)), "int8")
    q = quant.quantize(torch.as_tensor(
        rng.standard_normal((70, 64)).astype(np.float32)), "int8")
    ids = torch.arange(300, dtype=torch.int32)
    s = knn_ops.ref.score(docs.data, ids, q.data, docs.scale, q.scale)
    acc = q.data.to(torch.int64) @ docs.data.to(torch.int64).T
    want = (acc.to(torch.float32) * q.scale[:, None]) * docs.scale[None, :]
    assert s.dtype == torch.float32 and torch.equal(s, want)
