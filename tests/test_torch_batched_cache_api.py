"""The reference API the port's cache, index and front door expose, on the CPU.

The cases of ``tests/test_batched_cache.py`` run through both packages on
the same numpy inputs: the JAX ``BatchedMetricCache`` and batched / scalar
ops, and the port's ``BatchedMetricCache.probe`` / ``query`` / ``insert``
and scalar ops on CPU tensors.  States must be equal at their logical
extents (``repro_torch.convert``), hits, nearest records, ids, slots and
drop counts equal, f32 scores and r_hat within 1e-6.  Then the other names
the port lacked: ``cache_ops.reset_sessions``, ``metric_index.chunked_nn``
and ``masked_chunked_nn``, ``SessionManager.batcher`` and the exports of
``repro_torch.core``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.core import cache as J
from repro.core import metric_index as jmi
from repro_torch import convert
from repro_torch.core import cache_ops as tc
from repro_torch.core import metric_index as tmi
from repro_torch.core.cache import BatchedMetricCache
from repro_torch.serve.session import SessionManager

jax.config.update("jax_platform_name", "cpu")

DIM = 8


def _unit(rng, n, d=DIM):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _states_equal(port, ref, cfg):
    a = convert.cache_state_to_numpy(port, cfg)
    b = convert.cache_state_to_numpy(ref, cfg)
    for f in tc.CacheState._fields:
        if f in ("doc_scale", "q_scale"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       rtol=2e-7, atol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f)


def _probe_equal(port, ref):
    np.testing.assert_array_equal(port.hit.numpy(), np.asarray(ref.hit))
    np.testing.assert_array_equal(port.nearest_q.numpy(),
                                  np.asarray(ref.nearest_q))
    np.testing.assert_allclose(port.r_hat.numpy(), np.asarray(ref.r_hat),
                               atol=1e-6, rtol=0)


def _query_equal(port, ref):
    (ps, pd, pi, psl), (rs, rd, ri, rsl) = port, ref
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(psl.numpy(), np.asarray(rsl))
    for p, r in ((ps, rs), (pd, rd)):
        r = np.asarray(r)
        fin = np.isfinite(r)
        np.testing.assert_array_equal(np.isfinite(p.numpy()), fin)
        np.testing.assert_allclose(p.numpy()[fin], r[fin], atol=1e-6, rtol=0)


def _wave(rng, S, KC, wave):
    return dict(psi=_unit(rng, S), emb=_unit(rng, S * KC).reshape(S, KC, DIM),
                ids=rng.integers(0, 60, (S, KC)).astype(np.int32),
                radius=rng.uniform(0.4, 1.0, S).astype(np.float32),
                do=(np.ones(S, bool) if wave == 0
                    else rng.integers(0, 2, S).astype(bool)),
                record=rng.integers(0, 2, S).astype(bool))


@pytest.mark.parametrize("eviction", ["none", "lru", "ball"])
def test_batched_cache_waves_match_jax(eviction):
    """Five waves of probe -> gated insert -> query over 4 sessions: the
    port's ``BatchedMetricCache`` against the JAX one, and the port's
    scalar ops, session by session, against the JAX scalar ops."""
    kw = dict(capacity=32, dim=DIM, max_queries=4, eviction=eviction)
    jcfg, tcfg = J.CacheConfig(**kw), tc.CacheConfig(**kw)
    S, KC, K = 4, 10, 5
    rng = np.random.default_rng(7)
    jcache = J.BatchedMetricCache(jcfg, S)
    tcache = BatchedMetricCache(tcfg, S, device="cpu")
    jscalar = [J.init_cache(jcfg) for _ in range(S)]
    tscalar = [tc.init_cache(tcfg, "cpu") for _ in range(S)]
    for wave in range(5):
        w = _wave(rng, S, KC, wave)
        _probe_equal(tcache.probe(w["psi"]), jcache.probe(jnp.asarray(w["psi"])))
        jcache.insert(*(jnp.asarray(w[f]) for f in ("psi", "radius", "emb",
                                                    "ids")),
                      do=jnp.asarray(w["do"]), record=jnp.asarray(w["record"]))
        tcache.insert(w["psi"], w["radius"], w["emb"], w["ids"], do=w["do"],
                      record=w["record"])
        assert tcache.total_dropped == jcache.total_dropped
        _query_equal(tcache.query(w["psi"], K),
                     jcache.query(jnp.asarray(w["psi"]), K))
        _states_equal(tcache.state, jcache.state, tcfg)
        for s in range(S):
            psi = w["psi"][s]
            _probe_equal(tc.probe(tscalar[s], torch.as_tensor(psi),
                                  tcfg.epsilon),
                         J.probe(jscalar[s], jnp.asarray(psi), jcfg.epsilon))
            if w["do"][s]:
                args = (psi, w["radius"][s], w["emb"][s], w["ids"][s])
                jscalar[s], jdrop = J.insert(
                    jscalar[s], jcfg, *(jnp.asarray(a) for a in args),
                    jnp.asarray(w["record"][s]))
                tscalar[s], tdrop = tc.insert(
                    tscalar[s], tcfg, *(torch.as_tensor(a) for a in args),
                    bool(w["record"][s]))
                assert int(tdrop) == int(jdrop)
            tout, tscalar[s] = tc.query(tscalar[s], torch.as_tensor(psi), K)
            jout, jscalar[s] = J.query(jscalar[s], jnp.asarray(psi), K)
            _query_equal(tout, jout)
            _states_equal(tscalar[s], jscalar[s], tcfg)
    # the batched cache equals the stacked scalar states
    for s in range(S):
        _states_equal(tc.CacheState(*(x[s] for x in tcache.state)),
                      tscalar[s], tcfg)


def test_hit_sessions_state_untouched_as_in_jax():
    """do=False sessions keep their state bit for bit across an insert."""
    kw = dict(capacity=16, dim=DIM)
    jcfg, tcfg = J.CacheConfig(**kw), tc.CacheConfig(**kw)
    S, KC = 3, 6
    rng = np.random.default_rng(1)
    psi, emb = _unit(rng, S), _unit(rng, S * KC).reshape(S, KC, DIM)
    ids = np.arange(S * KC, dtype=np.int32).reshape(S, KC)
    radius = np.full(S, 0.7, np.float32)
    jc, tcache = J.BatchedMetricCache(jcfg, S), BatchedMetricCache(tcfg, S,
                                                                   "cpu")
    jargs = [jnp.asarray(a) for a in (psi, radius, emb, ids)]
    jc.insert(*jargs)
    tcache.insert(psi, radius, emb, ids)
    before = [x[1].clone() for x in tcache.state]
    do = np.array([True, False, True])
    jc.insert(*jargs, do=jnp.asarray(do))
    tcache.insert(psi, radius, emb, ids, do=do)
    for f, a, b in zip(tc.CacheState._fields, before, tcache.state):
        assert torch.equal(a, b[1]), f
    assert tcache.state.step.tolist() == [2, 1, 2]
    _states_equal(tcache.state, jc.state, tcfg)
    assert tcache.total_dropped == jc.total_dropped


def _filled_caches(S=3, KC=4):
    """A JAX and a port cache of S sessions after one insert each."""
    kw = dict(capacity=16, dim=DIM)
    jcfg, tcfg = J.CacheConfig(**kw), tc.CacheConfig(**kw)
    rng = np.random.default_rng(2)
    args = (_unit(rng, S), np.full(S, 0.5, np.float32),
            _unit(rng, S * KC).reshape(S, KC, DIM),
            np.arange(S * KC, dtype=np.int32).reshape(S, KC))
    jc, tcache = J.BatchedMetricCache(jcfg, S), BatchedMetricCache(tcfg, S,
                                                                   "cpu")
    jc.insert(*(jnp.asarray(a) for a in args))
    tcache.insert(*args)
    assert tcache.n_docs.tolist() == [KC] * S
    return jcfg, tcfg, jc, tcache


def _reset_one_in_place(tcache, sessions, slot, tcfg):
    """``tcache.reset(sessions)`` empties ``slot`` in place: the row equals
    ``init_cache``, every other row and every leaf's storage is unchanged."""
    before = [x.clone() for x in tcache.state]
    ptrs = [x.data_ptr() for x in tcache.state]
    tcache.reset(sessions)
    assert [x.data_ptr() for x in tcache.state] == ptrs
    _states_equal(tc.CacheState(*(x[slot] for x in tcache.state)),
                  tc.init_cache(tcfg, "cpu"), tcfg)
    for f, a, b in zip(tc.CacheState._fields, before, tcache.state):
        keep = [s for s in range(tcache.n_sessions) if s != slot]
        assert torch.equal(a[keep], b[keep]), f


def test_reset_sessions_isolates_one_session_as_in_jax():
    jcfg, tcfg, jc, tcache = _filled_caches()
    KC = 4
    mask = np.array([False, True, False])
    # the functional reset of the JAX package, the in-place one here
    jstate = J.reset_sessions(jc.state, jcfg, jnp.asarray(mask))
    tstate = tc.CacheState(*(x.clone() for x in tcache.state))
    assert tc.reset_sessions(tstate, tcfg, mask) is tstate
    _states_equal(tstate, jstate, tcfg)
    jc.reset([1])
    _reset_one_in_place(tcache, [1], 1, tcfg)
    assert tcache.n_docs.tolist() == [KC, 0, KC]
    assert tcache.n_queries.tolist() == [1, 0, 1]
    _states_equal(tcache.state, jc.state, tcfg)
    _states_equal(tc.CacheState(*(x[1] for x in tcache.state)),
                  J.init_cache(jcfg), tcfg)
    _states_equal(tstate, tcache.state, tcfg)


@pytest.mark.parametrize("sessions", [1, np.int64(1), torch.tensor([1])],
                         ids=["int", "np_int", "index_tensor"])
def test_reset_one_slot_in_place_as_list_and_jax(sessions):
    """A host slot given as an ``int`` (the open's), a numpy integer or a
    one-element host index resets the row as ``reset([1])`` does, here and
    in the JAX package; a slot outside the cache is refused."""
    _, tcfg, jc, tcache = _filled_caches()
    *_, twin = _filled_caches()
    _reset_one_in_place(tcache, sessions, 1, tcfg)
    twin.reset([1])
    jc.reset([1])
    for a, b in zip(tcache.state, twin.state):
        assert torch.equal(a, b)
    _states_equal(tcache.state, jc.state, tcfg)
    with pytest.raises(IndexError):
        tcache.reset(3)
    with pytest.raises(IndexError):
        tcache.reset(-1)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_reset_one_slot_in_place_at_each_storage_dtype(dtype):
    """With a narrower payload the row's leaves span three dtypes, one
    ``_foreach_copy_`` each; the host slot's reset equals the list's."""
    cfg = tc.CacheConfig(capacity=16, dim=DIM, store_dtype=dtype)
    rng = np.random.default_rng(4)
    args = (_unit(rng, 3), np.full(3, 0.5, np.float32),
            _unit(rng, 12).reshape(3, 4, DIM),
            np.arange(12, dtype=np.int32).reshape(3, 4))
    a, b = (BatchedMetricCache(cfg, 3, "cpu") for _ in range(2))
    for c in (a, b):
        c.insert(*args)
    assert len({x.dtype for x in a.state}) == 3
    _reset_one_in_place(a, 2, 2, cfg)
    b.reset([2])
    for x, y in zip(a.state, b.state):
        assert torch.equal(x, y)


def test_gather_scatter_roundtrip_as_in_jax():
    kw = dict(capacity=8, dim=DIM)
    jcfg, tcfg = J.CacheConfig(**kw), tc.CacheConfig(**kw)
    rng = np.random.default_rng(3)
    psi = _unit(rng, 4)
    args = (psi, np.full(4, 0.5, np.float32),
            _unit(rng, 4 * 3).reshape(4, 3, DIM),
            np.arange(12, dtype=np.int32).reshape(4, 3))
    jc, tcache = J.BatchedMetricCache(jcfg, 4), BatchedMetricCache(tcfg, 4,
                                                                   "cpu")
    jc.insert(*(jnp.asarray(a) for a in args))
    tcache.insert(*args)
    before = [x.clone() for x in tcache.state]
    jsub = jc.gather([0, 2])
    jout, jsub = J.query_batched(jsub, jnp.asarray(psi[[0, 2]]), 2)
    jc.scatter([0, 2], jsub)
    tsub = tcache.gather([0, 2])
    tout, tsub = tc.query_batched(tsub, torch.as_tensor(psi[[0, 2]]), 2)
    tcache.scatter([0, 2], tsub)
    _query_equal(tout, jout)
    for f, a, b in zip(tc.CacheState._fields, before, tcache.state):
        assert torch.equal(a[1], b[1]) and torch.equal(a[3], b[3]), f
    assert int(tcache.state.step[0]) == int(before[7][0]) + 1
    _states_equal(tcache.state, jc.state, tcfg)


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_memory_bytes_counts_every_leaf(dtype):
    cfg = tc.CacheConfig(capacity=100, dim=33, max_queries=5,
                         store_dtype=dtype)
    cache = BatchedMetricCache(cfg, 3, device="cpu")
    one = tcore.MetricCache(cfg, device="cpu").memory_bytes()
    isz = {"fp32": 4, "bf16": 2, "int8": 1}[dtype]
    cp, dp, qp = cfg.phys_capacity, cfg.phys_dim, cfg.phys_max_queries
    assert one == cp * dp * isz + qp * dp * isz + cp * 12 + qp * 8
    assert cache.memory_bytes() == 3 * one


@pytest.mark.parametrize("masked", [False, True])
def test_chunked_nn_matches_jax(masked):
    rng = np.random.default_rng(5)
    docs = _unit(rng, 512, 24)
    ids = np.arange(512, dtype=np.int32)
    if masked:
        ids[[3, 100, 101]] = -1
    q = _unit(rng, 7, 24)
    fn = (tmi.masked_chunked_nn, jmi.masked_chunked_nn) if masked \
        else (tmi.chunked_nn, jmi.chunked_nn)
    port = fn[0](*(torch.as_tensor(a) for a in (docs, ids, q)), 20, chunk=128)
    ref = fn[1](*(jnp.asarray(a) for a in (docs, ids, q)), 20, chunk=128)
    assert isinstance(port, tmi.SearchResult)
    np.testing.assert_array_equal(port.ids.numpy(), np.asarray(ref.ids))
    for f in ("scores", "distances"):
        np.testing.assert_allclose(getattr(port, f).numpy(),
                                   np.asarray(getattr(ref, f)), atol=1e-6)


def test_session_manager_batcher_is_the_scheduler():
    assert isinstance(SessionManager.batcher, property)
    mgr = SessionManager.__new__(SessionManager)
    mgr.scheduler = object()
    assert mgr.batcher is mgr.scheduler


def test_core_exports_the_reference_names_it_has():
    # every name of repro.core, and the assignment step beside the build
    assert set(tcore.__all__) == set(jcore.__all__) | {"assign_clusters"}
    for name in tcore.__all__:
        assert getattr(tcore, name) is not None, name
