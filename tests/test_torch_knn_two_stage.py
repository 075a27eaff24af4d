"""The port's two-stage kNN scan against the JAX package, on the CPU.

The same numpy corpus and queries go through JAX ``knn_search(two_stage=
True)`` with its Pallas ``knn_tile_topk`` in interpret mode and through the
port's ``knn_search(two_stage=True)`` on CPU tensors (``ref.tile_topk``,
the plain version beside the fused CUDA tile kernel, then the merge
through ``knn_select``).  Ids
are equal; scores agree within 1e-6.

Covered: a cluster of top documents packed into one tile with
``k_eff = tile_n < k`` (every row of a tile is then a candidate, so the
answer is the exact top-k), interior and trailing sentinel rows, k above
the valid rows, fp32 / bf16 / int8 and int8-dot, the ``tiles * k_eff < k``
refusal, and ``autotune_knn`` against the JAX tuner over a grid.  These
mirror ``tests/test_kernel_equivalence.py``'s two-stage checks.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.kernels.knn.ops import autotune_knn as jautotune
from repro.kernels.knn.ops import knn_search as jknn_search
from repro_torch import convert
from repro_torch.kernels import dispatch
from repro_torch.kernels.knn import ops as knn_ops
from repro_torch.kernels.knn import ref as knn_ref

jax.config.update("jax_platform_name", "cpu")


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _world(seed, n, dim, b, dtype):
    """Corpus of n >= 100 rows with a cluster of near-duplicates of query 0
    packed into rows 70..97 and sentinel rows inside and at the end (fewer
    rows: random rows, no sentinels)."""
    rng = np.random.default_rng(seed)
    docs = _unit(rng.standard_normal((n, dim))).astype(np.float32)
    q = _unit(rng.standard_normal((b, dim))).astype(np.float32)
    ids = np.arange(n, dtype=np.int32) + 100
    if n >= 100:
        docs[70:98] = _unit(q[0] + 0.05 * rng.standard_normal((28, dim)))
        docs[40] = docs[71]                   # an exact tie across tiles
        ids[[5, 72, n - 3, n - 2, n - 1]] = -1
    qc = jquant.quantize(jnp.asarray(docs), dtype)
    scale = None if qc.scale is None else np.array(qc.scale)
    return np.array(qc.data), scale, ids, q


def _both(data, scale, ids, q, k, tile_n, int8_dot):
    jscale = None if scale is None else jnp.asarray(scale)
    ref = jknn_search(jnp.asarray(data), jnp.asarray(ids), jnp.asarray(q), k,
                      tile_n=tile_n, backend="interpret", two_stage=True,
                      scale=jscale, int8_dot=int8_dot)
    docs, tscale, tids = convert.corpus_from_numpy(data, scale, ids,
                                                   device="cpu")
    port = knn_ops.knn_search(docs, tids, torch.as_tensor(q), k,
                              scale=tscale, int8_dot=int8_dot,
                              tile_n=tile_n, two_stage=True)
    return port, ref


def _assert_equal(port, ref):
    ps, pi = (x.numpy() for x in port)
    rs, ri = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_array_equal(np.isneginf(ps), np.isneginf(rs))
    fin = np.isfinite(rs)
    np.testing.assert_allclose(ps[fin], rs[fin], atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype,int8_dot", [("fp32", False), ("bf16", False),
                                            ("int8", False), ("int8", True)])
@pytest.mark.parametrize("k,tile_n", [(24, 16), (20, 64), (40, None)])
def test_two_stage_matches_jax(dtype, int8_dot, k, tile_n):
    data, scale, ids, q = _world(3, 230, 45, 4, dtype)
    dispatch.reset_counters()
    port, ref = _both(data, scale, ids, q, k, tile_n, int8_dot)
    c = dispatch.counters()
    # the fused tile kernel, then the merge through the select
    assert (c["knn_tile_topk"].calls, c["knn_select"].calls) == (1, 1)
    assert c["knn_score"].calls == 0
    _assert_equal(port, ref)
    top = port[1].numpy()[0]
    assert not np.isin([105, 172, 327, 328, 329], port[1].numpy()).any()
    # the packed cluster fills the head of query 0's answer
    assert np.isin(top[:10], np.r_[140, 170:198]).all()
    # k_eff = min(k, tile_n): a tile smaller than k gives all its rows, so
    # the two-stage answer is the exact top-k
    docs, tscale, tids = convert.corpus_from_numpy(data, scale, ids,
                                                   device="cpu")
    exact = knn_ops.knn_search(docs, tids, torch.as_tensor(q), k,
                               scale=tscale, int8_dot=int8_dot)
    _assert_equal(port, tuple(x.numpy() for x in exact))


@pytest.mark.parametrize("two_stage_k,tile_n", [(16, 8), (8, None)])
def test_two_stage_past_the_valid_rows(two_stage_k, tile_n):
    """k above the valid rows: the tail is (-inf, -1) in both packages."""
    data, scale, ids, q = _world(4, 12, 33, 3, "fp32")
    ids = ids.copy()
    ids[6:] = -1
    port, ref = _both(data, scale, ids, q, two_stage_k, tile_n, False)
    _assert_equal(port, ref)
    assert (port[1].numpy()[:, 6:] == -1).all()
    assert torch.isneginf(port[0][:, 6:]).all()


def test_two_stage_refuses_a_short_candidate_pool():
    """tiles * k_eff < k: the JAX wrapper asserts, the port raises."""
    data, scale, ids, q = _world(5, 5, 16, 2, "fp32")
    with pytest.raises(AssertionError):
        jknn_search(jnp.asarray(data), jnp.asarray(ids), jnp.asarray(q), 12,
                    backend="interpret", two_stage=True)
    with pytest.raises(ValueError, match="candidate pool"):
        knn_ops.knn_search(torch.as_tensor(data), torch.as_tensor(ids),
                           torch.as_tensor(q), 12, two_stage=True)


def test_tile_topk_plain_version_order():
    """``ref.tile_topk``: per tile the stable top k_eff (ties to the lower
    position), positions past the corpus at -inf."""
    docs = torch.zeros((10, 32))
    docs[:, 0] = torch.tensor([1, 3, 3, 2, 0, 5, 5, 5, 1, 4.0])
    ids = torch.arange(10, dtype=torch.int32)
    q = torch.zeros((1, 32))
    q[0, 0] = 1.0
    vals, pos = knn_ref.tile_topk(docs, ids, q, 3, 4)
    assert vals.shape == (3, 1, 3)
    assert pos[:, 0].tolist() == [[1, 2, 3], [5, 6, 7], [9, 8, 10]]
    assert torch.isneginf(vals[2, 0, 2])
    s, i = knn_ref.merge_tiles(vals, pos, ids, 9)
    # k_eff = 3 < tile_n = 4 drops position 0 (score 1) and 4 (score 0)
    assert i[0].tolist() == [5, 6, 7, 9, 1, 2, 3, 8, -1]


def test_autotune_matches_jax_grid():
    grid = itertools.product((5, 100, 4097, 65536, 1_000_000, 8_841_823),
                             (16, 45, 769, 800), (1, 7, 64), (1, 10, 200, 1000),
                             (1, 2, 4))
    for n, d, b, k, itemsize in grid:
        assert knn_ops.autotune_knn(n, d, b, k, itemsize) == \
            jautotune(n, d, b, k, itemsize), (n, d, b, k, itemsize)
