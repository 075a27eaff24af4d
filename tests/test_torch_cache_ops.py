"""The port's cache ops against the JAX package, on the CPU.

Scripted streams of gated inserts, queries and probes (the paper's
no-eviction policy here, LRU and ball eviction in
``test_torch_cache_evict.py``) under every store dtype run through the JAX
ops (the Pallas wave kernels in interpret mode, or the jnp reference) and
through the port's ops on CPU tensors.  After every step the two states must be equal at their logical
extents (``repro_torch.convert``), stamps and ring included; ids, slots and
drop counts equal; f32 scores within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache_ops as jc
from repro_torch import convert
from repro_torch.core import cache_ops as tc
from repro_torch.core.cache import BatchedMetricCache

jax.config.update("jax_platform_name", "cpu")

S, CAP, DIM, MAXQ, KC, K = 3, 40, 33, 4, 12, 5


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _assert_states_equal(tstate, jstate, cfg):
    port = convert.cache_state_to_numpy(tstate, cfg)
    ref = convert.cache_state_to_numpy(jstate, cfg)
    for f in tc.CacheState._fields:
        a, b = getattr(port, f), getattr(ref, f)
        if f in ("doc_scale", "q_scale"):
            np.testing.assert_allclose(a, b, rtol=2e-7, atol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


def _assert_out_equal(port, ref):
    (ps, pd, pi, psl), (rs, rd, ri, rsl) = port, ref
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(psl.numpy(), np.asarray(rsl))
    rs = np.asarray(rs)
    fin = np.isfinite(rs)
    np.testing.assert_array_equal(np.isfinite(ps.numpy()), fin)
    np.testing.assert_allclose(ps.numpy()[fin], rs[fin], atol=1e-6, rtol=0)


def _stream(rng, table):
    psi = _unit(rng.standard_normal((S, DIM)))
    radius = rng.uniform(0.1, 1.0, S).astype(np.float32)
    ids = rng.integers(0, table.shape[0], (S, KC))
    ids[:, 3] = ids[:, 1]                           # in-batch duplicate
    ids[rng.random((S, KC)) < 0.15] = -1            # sentinel padding
    emb = table[np.maximum(ids, 0)]
    do = rng.random(S) < 0.85
    record = rng.random(S) < 0.9
    return psi, radius, emb, ids.astype(np.int32), do, record


def run_stream(dtype, eviction):
    """Eight gated insert waves (fused insert+query on the interpret
    kernel, or insert then query), each followed by a probe, compared with
    the JAX ops after every step."""
    rng = np.random.default_rng(["fp32", "bf16", "int8"].index(dtype) * 3
                                + ["none", "lru", "ball"].index(eviction))
    table = _unit(rng.standard_normal((70, DIM)))
    jcfg = jc.CacheConfig(capacity=CAP, dim=DIM, max_queries=MAXQ,
                          eviction=eviction, store_dtype=dtype)
    tcfg = tc.CacheConfig(capacity=CAP, dim=DIM, max_queries=MAXQ,
                          eviction=eviction, store_dtype=dtype)
    js = jc.init_batched_cache(jcfg, S)
    ts = tc.init_batched_cache(tcfg, S, device="cpu")
    _assert_states_equal(ts, js, tcfg)
    dropped_any = 0
    for step in range(8):
        psi, radius, emb, ids, do, record = _stream(rng, table)
        jargs = (jnp.asarray(psi), jnp.asarray(radius), jnp.asarray(emb),
                 jnp.asarray(ids))
        targs = (torch.as_tensor(psi), torch.as_tensor(radius),
                 torch.as_tensor(emb), torch.as_tensor(ids))
        if step % 3 == 0:       # fused insert + query, interpret kernel
            rout, js, rdrop = jc.insert_query_batched(
                js, jcfg, *jargs, K, do=jnp.asarray(do),
                record=jnp.asarray(record), backend="interpret")
            pout, ts, pdrop = tc.insert_query_batched(
                ts, tcfg, *targs, K, do=torch.as_tensor(do),
                record=torch.as_tensor(record))
        else:                   # insert, then query
            js, rdrop = jc.insert_batched(
                js, jcfg, *jargs, do=jnp.asarray(do),
                record=jnp.asarray(record),
                backend="interpret" if step % 3 == 1 else "ref")
            ts, pdrop = tc.insert_batched(ts, tcfg, *targs,
                                          do=torch.as_tensor(do),
                                          record=torch.as_tensor(record))
            rout, js = jc.query_batched(js, jnp.asarray(psi), K,
                                        backend="ref")
            pout, ts = tc.query_batched(ts, torch.as_tensor(psi), K)
        np.testing.assert_array_equal(pdrop.numpy(), np.asarray(rdrop))
        dropped_any += int(np.asarray(rdrop).sum())
        _assert_out_equal(pout, rout)
        _assert_states_equal(ts, js, tcfg)
        pr = tc.probe_batched(ts, torch.as_tensor(psi), 0.04,
                              max_queries=MAXQ)
        rr = jc.probe_batched(js, jnp.asarray(psi), 0.04, backend="ref",
                              max_queries=MAXQ)
        np.testing.assert_array_equal(pr.hit.numpy(), np.asarray(rr.hit))
        np.testing.assert_array_equal(pr.nearest_q.numpy(),
                                      np.asarray(rr.nearest_q))
    assert convert.cache_state_to_numpy(ts, tcfg).n_queries.max() > MAXQ
    if eviction == "none":
        assert dropped_any > 0        # the stream overflows the capacity


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_batched_stream_matches_jax(dtype):
    run_stream(dtype, "none")


def test_scalar_ops_match_jax():
    rng = np.random.default_rng(5)
    table = _unit(rng.standard_normal((50, DIM)))
    jcfg = jc.CacheConfig(capacity=CAP, dim=DIM, max_queries=MAXQ,
                          eviction="lru")
    tcfg = tc.CacheConfig(capacity=CAP, dim=DIM, max_queries=MAXQ,
                          eviction="lru")
    js, ts = jc.init_cache(jcfg), tc.init_cache(tcfg, device="cpu")
    for step in range(5):
        psi = _unit(rng.standard_normal(DIM))
        ids = rng.integers(0, 50, KC).astype(np.int32)
        js, rdrop = jc.insert(js, jcfg, jnp.asarray(psi), 0.5,
                              jnp.asarray(table[ids]), jnp.asarray(ids),
                              record=step != 2)
        ts, pdrop = tc.insert(ts, tcfg, torch.as_tensor(psi), 0.5,
                              torch.as_tensor(table[ids]),
                              torch.as_tensor(ids), record=step != 2)
        assert int(pdrop) == int(rdrop)
        rout, js = jc.query(js, jnp.asarray(psi), K)
        pout, ts = tc.query(ts, torch.as_tensor(psi), K)
        _assert_out_equal(pout, rout)
        rp = jc.probe(js, jnp.asarray(psi), 0.04, max_queries=MAXQ)
        pp = tc.probe(ts, torch.as_tensor(psi), 0.04, max_queries=MAXQ)
        assert bool(pp.hit) == bool(rp.hit)
        assert int(pp.nearest_q) == int(rp.nearest_q)
        _assert_states_equal(ts, js, tcfg)


def test_dedup_mask_matches_jax():
    rng = np.random.default_rng(9)
    new = rng.integers(-1, 20, (4, 30)).astype(np.int32)
    existing = rng.integers(-1, 40, (4, 64)).astype(np.int32)
    ref = np.stack([np.asarray(jc.dedup_mask(jnp.asarray(n), jnp.asarray(e)))
                    for n, e in zip(new, existing)])
    port = tc.dedup_mask(torch.as_tensor(new), torch.as_tensor(existing))
    np.testing.assert_array_equal(port.numpy(), ref)


def test_batched_cache_gather_scatter_reset_and_convert():
    """gather copies rows, scatter writes them back, reset restores the
    sentinels; a JAX state carried across round-trips at logical extents."""
    rng = np.random.default_rng(2)
    table = _unit(rng.standard_normal((30, DIM)))
    cfg = tc.CacheConfig(capacity=CAP, dim=DIM, max_queries=MAXQ)
    cache = BatchedMetricCache(cfg, 4, device="cpu")
    ids = rng.integers(0, 30, (2, KC)).astype(np.int32)
    sub = cache.gather([1, 3])
    psi = torch.as_tensor(_unit(rng.standard_normal((2, DIM))))
    tc.insert_batched(sub, cfg, psi, torch.full((2,), 0.4),
                      torch.as_tensor(table[ids]), torch.as_tensor(ids))
    assert int(cache.state.n_docs.sum()) == 0           # gather copied
    cache.scatter([1, 3], sub)
    np.testing.assert_array_equal(cache.n_docs,
                                  [0, int(sub.n_docs[0]), 0,
                                   int(sub.n_docs[1])])
    ok, problems = tc.validate_state(cache.state, cfg, n_corpus=30)
    assert ok.all(), problems
    cache.reset([3])
    assert cache.n_docs[3] == 0 and cache.n_queries[3] == 0
    assert (cache.state.doc_ids[3] == -1).all()

    jcfg = jc.CacheConfig(capacity=CAP, dim=DIM, max_queries=MAXQ)
    js = jc.init_batched_cache(jcfg, 2)
    js, _ = jc.insert_batched(js, jcfg, jnp.asarray(psi.numpy()),
                              jnp.full((2,), 0.4), jnp.asarray(table[ids]),
                              jnp.asarray(ids), backend="ref")
    carried = convert.cache_state_from_numpy(js, cfg, device="cpu")
    assert carried.doc_emb.shape == (2, cfg.phys_capacity, cfg.phys_dim)
    _assert_states_equal(carried, js, cfg)
    _assert_states_equal(sub, js, cfg)
