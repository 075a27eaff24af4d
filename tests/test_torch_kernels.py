"""The port's probe and kNN ops against the JAX package, on the CPU.

The same numpy inputs go through the JAX function (its Pallas kernel in
interpret mode, and its jnp reference) and through the port's wrapper on
CPU tensors (the plain PyTorch version beside each CUDA kernel).  Decisions
and ids must be equal; f32 scores agree within 1e-6 (the two packages sum
dot products in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache_ops as jc
from repro.core import quant as jquant
from repro.kernels.knn.ops import knn_search as jknn_search
from repro_torch import convert
from repro_torch.core import cache_ops as tc
from repro_torch.core import quant as tquant
from repro_torch.kernels import dispatch
from repro_torch.kernels.knn.ops import knn_search

jax.config.update("jax_platform_name", "cpu")

DTYPES = ("fp32", "bf16", "int8")


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _probe_states(dtype, rng, s=6, dim=67, max_queries=5):
    """JAX batched state with records around each session's query:
    an empty cache, a partly filled ring and a wrapped ring."""
    cfg = jc.CacheConfig(capacity=24, dim=dim, max_queries=max_queries,
                         store_dtype=dtype)
    st = jc.init_batched_cache(cfg, s)
    leaves = {f: np.array(getattr(st, f)) for f in jc.CacheState._fields}
    psi = _unit(rng.standard_normal((s, dim))).astype(np.float32)
    n_queries = np.array([0, 1, 3, 5, 9, 17], np.int32)[:s]
    for i in range(s):
        noise = rng.standard_normal((max_queries, dim))
        recs = _unit(psi[i] + (0.3 + 0.1 * np.arange(max_queries))[:, None]
                     * noise / np.sqrt(dim)).astype(np.float32)
        data, scale = jc.store_rows(jnp.asarray(recs), dtype)
        leaves["q_emb"][i, :max_queries, :dim] = np.asarray(data)
        leaves["q_scale"][i, :max_queries] = np.asarray(scale)
        leaves["q_radius"][i, :max_queries] = rng.uniform(
            0.3, 1.1, max_queries).astype(np.float32)
    leaves["n_queries"] = n_queries
    jstate = jc.CacheState(**{f: jnp.asarray(v) for f, v in leaves.items()})
    tcfg = tc.CacheConfig(capacity=24, dim=dim, max_queries=max_queries,
                          store_dtype=dtype)
    return cfg, tcfg, jstate, psi


@pytest.mark.parametrize("dtype", DTYPES)
def test_probe_batched_matches_jax(dtype):
    rng = np.random.default_rng(7)
    jcfg, tcfg, jstate, psi = _probe_states(dtype, rng)
    tstate = convert.cache_state_from_numpy(jstate, tcfg, device="cpu")
    eps = 0.2
    port = tc.probe_batched(tstate, torch.as_tensor(psi), eps,
                            max_queries=tcfg.max_queries)
    hits = set()
    for backend in ("interpret", "ref"):
        ref = jc.probe_batched(jstate, jnp.asarray(psi), eps, backend=backend,
                               max_queries=jcfg.max_queries)
        np.testing.assert_array_equal(port.hit.numpy(), np.asarray(ref.hit))
        np.testing.assert_array_equal(port.nearest_q.numpy(),
                                      np.asarray(ref.nearest_q))
        np.testing.assert_allclose(port.r_hat.numpy(), np.asarray(ref.r_hat),
                                   atol=1e-6, rtol=0)
        hits.update(np.asarray(ref.hit).tolist())
    assert hits == {True, False}, "inputs must exercise hits and misses"
    assert port.nearest_q[0] == -1 and not port.hit[0]      # empty cache


def _corpus(rng, n, dim, dtype):
    docs = _unit(rng.standard_normal((n, dim))).astype(np.float32)
    qc = jquant.quantize(jnp.asarray(docs), dtype)
    scale = None if qc.scale is None else np.array(qc.scale)
    return np.array(qc.data), scale


def _assert_knn_equal(port, ref):
    ps, pi = (x.numpy() for x in port)
    rs, ri = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_array_equal(np.isneginf(ps), np.isneginf(rs))
    fin = np.isfinite(rs)
    np.testing.assert_allclose(ps[fin], rs[fin], atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype,int8_dot", [("fp32", False), ("bf16", False),
                                            ("int8", False), ("int8", True)])
def test_knn_search_matches_jax(dtype, int8_dot):
    """Sentinel rows, planted ties (duplicated documents), and k over the
    valid count, against the interpret-mode fused kernel."""
    rng = np.random.default_rng(11)
    n, dim, k = 150, 67, 20
    data, scale = _corpus(rng, n, dim, dtype)
    data[40] = data[3]                       # exact ties across positions
    data[90] = data[3]
    if scale is not None:
        scale[40] = scale[90] = scale[3]
    ids = np.arange(n, dtype=np.int32) + 1000
    ids[[5, 77, 120]] = -1                   # sentinel rows never win
    queries = _unit(rng.standard_normal((5, dim))).astype(np.float32)
    queries[1] = _unit(data[3].astype(np.float32)
                       * (1.0 if scale is None else scale[3]))
    ref = jknn_search(jnp.asarray(data), jnp.asarray(ids), jnp.asarray(queries),
                      k, backend="interpret",
                      scale=None if scale is None else jnp.asarray(scale),
                      int8_dot=int8_dot)
    docs_t, scale_t, ids_t = convert.corpus_from_numpy(data, scale, ids,
                                                       device="cpu")
    port = knn_search(docs_t, ids_t, torch.as_tensor(queries), k,
                      scale=scale_t, int8_dot=int8_dot)
    _assert_knn_equal(port, ref)
    row = port[1][1].numpy()
    assert {1003, 1040, 1090} <= set(row[:3].tolist())    # the tied trio
    assert not np.isin([1005, 1077, 1120], port[1].numpy()).any()

    # k above the valid count: -inf results carry id -1
    small = ids[:12].copy()
    small[4:] = -1
    ref = jknn_search(jnp.asarray(data[:12]), jnp.asarray(small),
                      jnp.asarray(queries), 16, backend="interpret",
                      scale=None if scale is None else jnp.asarray(scale[:12]),
                      int8_dot=int8_dot)
    port = knn_search(docs_t[:12], torch.as_tensor(small),
                      torch.as_tensor(queries), 16,
                      scale=None if scale_t is None else scale_t[:12],
                      int8_dot=int8_dot)
    _assert_knn_equal(port, ref)
    assert (port[1].numpy()[:, 4:] == -1).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_matches_jax(dtype):
    """Payloads equal; int8 scales within an ulp (the norms are summed in
    different orders)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((40, 33)).astype(np.float32)
    x[7] = 0.0
    ref = jquant.quantize(jnp.asarray(x), dtype)
    port = tquant.quantize(torch.as_tensor(x), dtype)
    np.testing.assert_array_equal(tc.to_numpy(port.data),
                                  tc.to_numpy(ref.data))
    if dtype == "int8":
        np.testing.assert_allclose(port.scale.numpy(), np.asarray(ref.scale),
                                   rtol=2e-7, atol=0)
    else:
        assert port.scale is None and ref.scale is None


def test_op_calls_counted_on_cpu():
    """A CPU call counts a wrapper entry and no launch."""
    rng = np.random.default_rng(0)
    data, _ = _corpus(rng, 30, 33, "fp32")
    docs, _, ids = convert.corpus_from_numpy(data, None, np.arange(30),
                                             device="cpu")
    dispatch.reset_counters()
    knn_search(docs, ids, torch.as_tensor(data[:2]), 4)
    c = dispatch.counters()
    assert (c["knn_score"].calls, c["knn_select"].calls) == (1, 1)
    assert c["knn_score"].launches == c["knn_select"].launches == 0
