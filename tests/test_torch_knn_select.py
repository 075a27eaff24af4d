"""The port's fused kNN search on the rows its select must survive, against
the JAX package, on the CPU.

The same numpy corpus and queries go through JAX ``knn_search`` (its ref
tier: one masked score matrix and a stable ``lax.top_k``) and through the
port's ``knn_search`` on CPU tensors (the plain versions beside the CUDA
score and select kernels).  Ids are equal; finite scores agree within 1e-5
and -inf where the JAX scores are -inf.

Entries are multiples of 1/8, so every score is exact in f32 in any
summation order and a tie is a tie in both packages (the CPU matmul sums
equal rows at different positions in different orders, so random unit
vectors would not tie exactly).  Cases: a run of duplicated documents
tied across rank k, a corpus of one repeated row (every score equal), runs
of sentinel rows (id -1, so rows may hold fewer than k finite scores), and
k = N (and k above N, which pads with (-inf, -1)); at B in {1, 2, 9, 64},
k in {1, 200, 1000}, for fp32, bf16, int8 and int8-dot corpora.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.kernels.knn.ops import knn_search as jknn_search
from repro_torch import convert
from repro_torch.kernels.knn import ops as knn_ops
from repro_torch.kernels.knn import ref as knn_ref

jax.config.update("jax_platform_name", "cpu")

N, DIM = 1200, 67
DTYPES = [("fp32", False), ("bf16", False), ("int8", False), ("int8", True)]
TOL = 1e-5


def _world(case, dtype, b, k, seed=5):
    """(payload, scale, ids, queries) of one case.  Entries are multiples
    of 1/8 in [-1, 1], so every dot product (and every int8 payload dot) is
    exact in f32 whatever order a package sums it in: equal payloads score
    equal in both packages, and so do the many chance ties.  Duplicated
    rows copy the payload and its scale."""
    rng = np.random.default_rng(seed)
    docs = (rng.integers(-8, 9, (N, DIM)) / 8).astype(np.float32)
    if case == "all_equal":
        docs[:] = docs[7]
    queries = (rng.integers(-8, 9, (b, DIM)) / 8).astype(np.float32)
    qc = jquant.quantize(jnp.asarray(docs), dtype)
    data = np.array(qc.data)
    scale = None if qc.scale is None else np.array(qc.scale)
    ids = np.arange(N, dtype=np.int32) + 10
    if case in ("ties", "k_equal_n"):
        # a tie run of 30 copies of the document at rank k of query 0
        order = np.argsort(-(docs @ queries[0]), kind="stable")
        src = order[min(k, N) - 1]
        dst = rng.choice(np.setdiff1d(np.arange(N), [src]), 30,
                         replace=False)
        data[dst] = data[src]
        if scale is not None:
            scale[dst] = scale[src]
    if case in ("sentinel_runs", "k_equal_n"):
        ids[100:400] = -1                    # a run of sentinel rows
        ids[-50:] = -1                       # and a trailing one
    return data, scale, ids, queries


def _search_both(data, scale, ids, queries, k, i8):
    ref = jknn_search(jnp.asarray(data), jnp.asarray(ids),
                      jnp.asarray(queries), k, backend="ref",
                      scale=None if scale is None else jnp.asarray(scale),
                      int8_dot=i8)
    docs_t, scale_t, ids_t = convert.corpus_from_numpy(data, scale, ids,
                                                       device="cpu")
    port = knn_ops.knn_search(docs_t, ids_t, torch.as_tensor(queries), k,
                              scale=scale_t, int8_dot=i8)
    return port, ref


def _assert_equal(port, ref, what):
    ps, pi = (x.numpy() for x in port)
    rs, ri = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(pi, ri, err_msg=what)
    np.testing.assert_array_equal(np.isneginf(ps), np.isneginf(rs),
                                  err_msg=what)
    fin = np.isfinite(rs)
    np.testing.assert_allclose(ps[fin], rs[fin], atol=TOL, rtol=0,
                               err_msg=what)


@pytest.mark.parametrize("dtype,i8", DTYPES)
@pytest.mark.parametrize("b", [1, 2, 9, 64])
@pytest.mark.parametrize("k", [1, 200, 1000])
@pytest.mark.parametrize("case", ["ties", "all_equal", "sentinel_runs"])
def test_knn_search_hard_rows_match_jax(dtype, i8, b, k, case):
    data, scale, ids, queries = _world(case, dtype, b, k)
    port, ref = _search_both(data, scale, ids, queries, k, i8)
    _assert_equal(port, ref, f"{case} {dtype} i8={i8} b={b} k={k}")
    got = port[1].numpy()
    if case == "all_equal":                  # every score equal: positions
        assert (got == np.arange(k) + 10).all()
    if case == "sentinel_runs":              # never a sentinel id; -1 only
        valid = np.sort(ids[ids >= 0])       # past the 850 valid rows
        assert not np.isin(np.arange(100, 400) + 10, got).any()
        assert (got[:, len(valid):] == -1).all()


@pytest.mark.parametrize("dtype,i8", DTYPES)
@pytest.mark.parametrize("b", [1, 2, 9, 64])
def test_knn_search_k_equal_n_matches_jax(dtype, i8, b):
    """k = N with a tie run and sentinel runs: every row ranked, the
    sentinels last as (-inf, -1)."""
    data, scale, ids, queries = _world("k_equal_n", dtype, b, N)
    port, ref = _search_both(data, scale, ids, queries, N, i8)
    _assert_equal(port, ref, f"k=N {dtype} i8={i8} b={b}")
    n_valid = int((ids >= 0).sum())
    assert (port[1].numpy()[:, n_valid:] == -1).all()
    assert (port[1].numpy()[:, :n_valid] >= 0).all()


@pytest.mark.parametrize("dtype,i8", DTYPES)
@pytest.mark.parametrize("b", [1, 9])
def test_knn_search_k_above_n_matches_jax(dtype, i8, b):
    """k past N with a tie run and sentinel runs: the N ranked rows, then
    (-inf, -1) padding."""
    k = N + 37
    data, scale, ids, queries = _world("k_equal_n", dtype, b, N)
    port, ref = _search_both(data, scale, ids, queries, k, i8)
    _assert_equal(port, ref, f"k>N {dtype} i8={i8} b={b}")
    n_valid = int((ids >= 0).sum())
    assert port[1].shape == (b, k)
    assert (port[1].numpy()[:, n_valid:] == -1).all()
    assert np.isneginf(port[0].numpy()[:, N:]).all()
