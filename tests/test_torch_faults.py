"""The port's fault model and degradation ladder against the JAX package,
on the CPU.

The cases of ``tests/test_faults.py``: the fault injector
(``repro_torch.serve.faults``, replayed call by call beside
``repro.serve.faults`` on the same shard answers: the same faults fire,
the same poison comes out), answer validation, the circuit breaker, the
router under faults, and ``BatchedEngine``'s ladder (load-shed waves, the
stale memo, the cache-state guard and quarantine) with its calls.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.metric_index import MetricIndex as JIndex
from repro.serve import faults as jfaults
from repro.serve.router import ShardAnswer as JAnswer
from repro_torch.core.cache import CacheConfig, MetricCache
from repro_torch.core.cache_ops import validate_state
from repro_torch.core.shared import SharedTier
from repro_torch.dist.retrieval import DeviceShard
from repro_torch.kernels import dispatch
from repro_torch.serve.engine import EngineTurn
from repro_torch.serve.faults import (CORRUPT_MODES, FaultError, FaultPlan,
                                      FaultSpec, FaultyShard, _corrupt,
                                      chaos_plan)
from repro_torch.serve.router import (AnswerValidationError, CircuitBreaker,
                                      ShardAnswer, ShardedRouter,
                                      validate_answer)
from repro_torch.serve.scheduler import ContinuousScheduler
from repro_torch.serve.session import BatchedEngine
from repro_torch.serve.telemetry import ServeTelemetry

jax.config.update("jax_platform_name", "cpu")

N_DOCS, DIM = 240, 32


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(3)
    return JIndex(jnp.asarray(rng.standard_normal((N_DOCS, DIM))
                              .astype(np.float32)))


@pytest.fixture(scope="module")
def docs(index):
    return np.asarray(index.dequantized()[:index.n_docs])


def make_shards(docs, n_shards, answer=ShardAnswer):
    ids = np.arange(len(docs))
    bounds = np.linspace(0, len(docs), n_shards + 1).astype(int)
    shards = []
    for i in range(n_shards):
        d, did = docs[bounds[i]:bounds[i + 1]], ids[bounds[i]:bounds[i + 1]]

        def shard(queries, k, d=d, did=did):
            scores = queries @ d.T
            top = np.argsort(-scores, axis=1, kind="stable")[:, :k]
            return answer(np.take_along_axis(scores, top, axis=1), did[top])
        shards.append(shard)
    return shards


def queries_for(index, n, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, DIM)).astype(np.float32)
    return np.asarray(index.transform_queries(jnp.asarray(q)))


def _outcome(shard, q, k):
    try:
        a = shard(q, k)
        return ("ok", np.asarray(a.scores), np.asarray(a.ids))
    except Exception as e:          # noqa: BLE001 - the kind is compared
        return (type(e).__name__,)


def _same(a, b):
    assert a[0] == b[0]
    if a[0] == "ok":
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])


# ------------------------------------------------------------ fault injector
def test_fault_spec_schedule_windows_and_flapping():
    for spec in (FaultSpec, jfaults.FaultSpec):
        solid = spec("error", start=3, stop=6)
        assert [solid.active(c) for c in range(8)] == \
            [False] * 3 + [True] * 3 + [False] * 2
        flap = spec("latency", start=2, period=3, width=1, delay_s=0.01)
        assert [flap.active(c) for c in range(2, 8)] == \
            [True, False, False, True, False, False]
        open_ended = spec("corrupt", start=5)
        assert not open_ended.active(4) and open_ended.active(10 ** 6)


@pytest.mark.parametrize("bad", [dict(kind="meteor"),
                                 dict(kind="error", period=2, width=3),
                                 dict(kind="corrupt", mode="garbled")])
def test_fault_spec_rejects_bad_specs(bad):
    with pytest.raises(ValueError):
        FaultSpec(**bad)


def test_faulty_shard_applies_each_kind(index, docs):
    inner = make_shards(docs, 1)[0]
    q = queries_for(index, 2)
    lat = FaultyShard(inner, [FaultSpec("latency", stop=1, delay_s=0.05)])
    t0 = time.perf_counter()
    lat(q, 5)
    assert time.perf_counter() - t0 >= 0.05
    t0 = time.perf_counter()
    lat(q, 5)
    assert time.perf_counter() - t0 < 0.04
    err = FaultyShard(inner, [FaultSpec("error", stop=1)])
    with pytest.raises(FaultError):
        err(q, 5)
    err(q, 5)
    assert err.calls == 2 and err.faults == 1
    bad = FaultyShard(inner, [FaultSpec("corrupt", mode="nan")])
    assert np.isnan(bad(q, 5).scores).any()
    clean = FaultyShard(inner)
    validate_answer(clean(q, 5), 2, 5, N_DOCS)
    assert clean.calls == 1 and clean.faults == 0


def test_faulty_shard_wraps_a_device_shard(index, docs):
    shard = DeviceShard(docs, np.arange(N_DOCS), device="cpu")
    faulty = FaultyShard(shard, [FaultSpec("corrupt", mode="oob")])
    ans = faulty(queries_for(index, 3), 4)
    assert ans.ids[0, 0] == 2 ** 40 and faulty.faults == 1
    with pytest.raises(AnswerValidationError):
        validate_answer(ans, 3, 4, N_DOCS)


@pytest.mark.parametrize("mode", list(CORRUPT_MODES) + ["mix"])
def test_corrupt_payload_equals_jax(mode):
    rng = np.random.default_rng(1)
    scores = rng.standard_normal((3, 7)).astype(np.float32)
    ids = rng.integers(0, 50, (3, 7))
    for call in range(5):
        got = _corrupt(ShardAnswer(scores, ids), mode, 7, call)
        want = jfaults._corrupt(JAnswer(scores, ids), mode, 7, call)
        np.testing.assert_array_equal(got.scores, want.scores)
        np.testing.assert_array_equal(got.ids, want.ids)


def test_chaos_plan_replays_the_jax_schedule_call_by_call(index, docs):
    """The committed chaos schedule, both packages, 40 calls a shard on
    the same answers: the same outcome each call, the same counters."""
    q = queries_for(index, 3)
    ours = chaos_plan(4, spike_s=0.0).wrap(make_shards(docs, 4))
    theirs = jfaults.chaos_plan(4, spike_s=0.0).wrap(
        make_shards(docs, 4, JAnswer))
    for _ in range(40):
        for a, b in zip(ours, theirs):
            _same(_outcome(a, q, 5), _outcome(b, q, 5))
    assert [(w.calls, w.faults) for w in ours] == \
        [(w.calls, w.faults) for w in theirs]


def test_fault_plan_is_deterministic(index, docs):
    q = queries_for(index, 2)

    def run():
        plan = FaultPlan({0: (FaultSpec("corrupt", mode="mix"),)}, seed=5)
        shard = plan.wrap(make_shards(docs, 1))[0]
        return [shard(q, 5) for _ in range(len(CORRUPT_MODES))]

    for a, b in zip(run(), run()):
        np.testing.assert_array_equal(a.scores, b.scores)
        np.testing.assert_array_equal(a.ids, b.ids)


def test_chaos_plan_shape(docs):
    with pytest.raises(ValueError):
        chaos_plan(2)
    plan = chaos_plan(4)
    wrapped = plan.wrap(make_shards(docs, 4))
    assert [len(w.specs) for w in wrapped] == [2, 1, 1, 0]
    assert plan.calls() == [0, 0, 0, 0]
    assert [w.specs for w in wrapped] == \
        [tuple(FaultSpec(**s.__dict__) for s in w.specs)
         for w in jfaults.chaos_plan(4).wrap(make_shards(docs, 4, JAnswer))]


# --------------------------------------------------------- answer validation
def test_validate_answer_accepts_sentinels_and_short_rows():
    validate_answer(ShardAnswer(np.array([[2.0, -np.inf], [1.0, 0.5]]),
                                np.array([[3, -1], [4, 0]])), 2, 5, n_docs=10)


def test_validate_answer_rejects_each_corrupt_mode():
    clean = ShardAnswer(
        np.array([[2.0, 1.0, 0.5], [1.5, 0.5, 0.2]], np.float32),
        np.array([[3, 1, 5], [4, 0, 2]]))
    validate_answer(clean, 2, 3, n_docs=10)
    for mode in CORRUPT_MODES:
        with pytest.raises(AnswerValidationError):
            validate_answer(_corrupt(clean, mode, seed=0, call=0), 2, 3,
                            n_docs=10)
    with pytest.raises(AnswerValidationError):
        validate_answer(clean, 3, 3, n_docs=10)
    with pytest.raises(AnswerValidationError):
        validate_answer(ShardAnswer(clean.scores,
                                    clean.ids.astype(np.float64)), 2, 3,
                        n_docs=10)
    with pytest.raises(AnswerValidationError):
        validate_answer(ShardAnswer(np.array([[-np.inf, 1.0]]),
                                    np.array([[3, 1]])), 1, 2, n_docs=10)


# ------------------------------------------------------------ circuit breaker
def test_circuit_breaker_state_machine():
    t = [0.0]
    seen = []
    br = CircuitBreaker(window=8, fail_rate=0.5, min_calls=4, cooldown_s=1.0,
                        clock=lambda: t[0],
                        on_transition=lambda old, new: seen.append((old, new)))
    for ok in (False, False, True):
        br.record(ok)
    assert br.state == "closed"
    br.record(False)
    assert br.state == "open" and br.opens == 1
    assert not br.allow() and not br.peek()
    t[0] = 1.0
    assert br.peek() and br.state == "open"
    assert br.allow() and br.state == "half_open"
    assert not br.allow()
    br.record(False)
    assert br.state == "open" and br.opens == 2
    t[0] = 2.0
    assert br.allow()
    br.record(True)
    assert br.state == "closed" and br.closes == 1
    assert ("closed", "open") in seen and ("half_open", "closed") in seen


# --------------------------------------------------------- router integration
def test_router_rejects_corrupt_answers_and_merge_stays_finite(index, docs):
    plan = FaultPlan({1: (FaultSpec("corrupt", mode="nan"),)}, seed=1)
    with ShardedRouter(plan.wrap(make_shards(docs, 3)), deadline_s=5.0,
                       n_docs=N_DOCS) as router:
        ans, degraded = router.search(queries_for(index, 4), 5)
        assert degraded and not np.isnan(ans.scores).any()
        assert (ans.ids < N_DOCS).all()
        assert router.stats.rejected >= 2 and router.stats.failures >= 1


def test_router_retry_recovers_transient_fault(index, docs):
    plan = FaultPlan({0: (FaultSpec("error", stop=1),)})
    with ShardedRouter(plan.wrap(make_shards(docs, 2)), deadline_s=5.0,
                       backoff_base_s=0.001, n_docs=N_DOCS) as router:
        ans, degraded = router.search(queries_for(index, 2), 5)
        assert not degraded and router.stats.retries >= 1
        assert router.stats.failures == 0
        validate_answer(ans, 2, 5, N_DOCS)


def test_router_breaker_opens_skips_and_recovers(index, docs):
    plan = FaultPlan({0: (FaultSpec("error", stop=6),)})
    q = queries_for(index, 2)
    with ShardedRouter(plan.wrap(make_shards(docs, 2)), deadline_s=5.0,
                       max_retries=1, backoff_base_s=0.001,
                       breaker_window=4, breaker_min_calls=2,
                       breaker_cooldown_s=0.05, n_docs=N_DOCS) as router:
        for _ in range(4):
            ans, degraded = router.search(q, 5)
            assert degraded
        assert router.stats.breaker_opens >= 1
        assert router.stats.breaker_skips >= 1
        assert not router.backend_open
        time.sleep(0.06)
        deadline = time.monotonic() + 5.0
        while router.breakers[0].state != "closed":
            router.search(q, 5)
            time.sleep(0.06)
            assert time.monotonic() < deadline
        assert router.stats.breaker_closes >= 1
        assert not router.search(q, 5)[1]


def test_router_all_shards_failed_but_one_pads_sentinels(index, docs):
    plan = FaultPlan({0: (FaultSpec("error"),), 1: (FaultSpec("error"),)})
    lo = 2 * N_DOCS // 3
    k = (N_DOCS - lo) + 3
    with ShardedRouter(plan.wrap(make_shards(docs, 3)), deadline_s=5.0,
                       max_retries=0, n_docs=N_DOCS) as router:
        ans, degraded = router.search(queries_for(index, 2), k)
        real = ans.ids >= 0
        assert degraded and ans.ids.shape == (2, k)
        assert (ans.ids[real] >= lo).all() and (~real).any()
        assert np.isneginf(ans.scores[~real]).all()


def test_router_stats_lock_no_lost_updates(index, docs):
    with ShardedRouter(make_shards(docs, 2), deadline_s=10.0) as router:
        def hammer():
            for _ in range(500):
                router.stats.bump("hedges")
        threads = [threading.Thread(target=hammer) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert router.stats.hedges == 4000
        q = queries_for(index, 2)
        threads = [threading.Thread(target=lambda: [router.search(q, 5)
                                                    for _ in range(5)])
                   for _ in range(6)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert router.stats.calls == 30
        assert sum(h["calls"] for h in router.shard_health()) == 60


def test_router_close_is_idempotent_and_context_managed(index, docs):
    router = ShardedRouter(make_shards(docs, 2), deadline_s=5.0)
    with router:
        assert not router.search(queries_for(index, 2), 5)[1]
    router.close()
    with pytest.raises(RuntimeError):
        router.search(queries_for(index, 2), 5)


# ------------------------------------------------------- degradation ladder
def _engine(docs, *, n_sessions=2, shared=None, router=None,
            validate_every=0, telemetry=None, epsilon=0.04, **router_kw):
    if router is None:
        kw = dict(deadline_s=5.0, n_docs=N_DOCS, breaker_window=4,
                  breaker_min_calls=2, breaker_cooldown_s=3600.0)
        kw.update(router_kw)
        router = ShardedRouter(make_shards(docs, 2), **kw)
    return BatchedEngine(router, docs, dim=docs.shape[1],
                         n_sessions=n_sessions, k=5, k_c=16, capacity=64,
                         shared=shared, validate_every=validate_every,
                         telemetry=telemetry, epsilon=epsilon, device="cpu")


def _fence(router):
    for b in router.breakers:
        b.record(False)
        b.record(False)
    assert router.backend_open


def test_engine_shed_wave_serves_cache_without_router(index, docs):
    tel = ServeTelemetry()
    eng = _engine(docs, telemetry=tel, epsilon=1e9)
    with eng.router:
        warm = eng.answer_batch([0, 1], list(queries_for(index, 2, seed=1)))
        assert all(isinstance(t, EngineTurn) for t in warm)
        _fence(eng.router)

        def boom(*a, **k):
            raise AssertionError("router.search called during shed wave")
        eng.router.search = boom
        before = int(eng.cache.state.n_queries.sum())
        turns = eng.answer_batch([0, 1], list(queries_for(index, 2, seed=2)))
        assert all(t.degraded and (t.ids >= 0).all() and t.ids.size
                   for t in turns)
        assert int(eng.cache.state.n_queries.sum()) == before
        assert tel.faults["shed_waves"] >= 1 and tel.faults["shed_turns"] >= 2
        assert tel.faults["degraded_turns"] >= 2


def test_engine_shed_then_breaker_recovery(index, docs):
    eng = _engine(docs, epsilon=1e9)
    router = eng.router
    t = [0.0]
    router.breakers = [
        CircuitBreaker(window=4, fail_rate=0.5, min_calls=2, cooldown_s=10.0,
                       clock=lambda: t[0],
                       on_transition=router._transition_cb(i))
        for i in range(len(router.shards))]
    with router:
        eng.answer_batch([0, 1], list(queries_for(index, 2, seed=1)))
        _fence(router)
        turns = eng.answer_batch([0, 1], list(queries_for(index, 2, seed=2)))
        assert all(t.degraded for t in turns)
        t[0] = 11.0
        assert not router.backend_open
        turns = eng.answer_batch([0, 1], list(queries_for(index, 2, seed=3)))
        assert all(isinstance(x, EngineTurn) and not x.degraded
                   for x in turns)
        assert all(b.state == "closed" for b in router.breakers)
        assert router.stats.breaker_closes >= 2


def test_stale_memo_served_under_outage_never_records(index, docs):
    shared = SharedTier(dim=docs.shape[1], n_shards=2, capacity=256,
                        memo_sim=0.9, ttl_waves=1, device="cpu")
    eng = _engine(docs, shared=shared)
    with eng.router:
        q = queries_for(index, 2, seed=4)
        eng.answer_batch([0, 1], list(q))
        for _ in range(3):
            shared.tick()
        assert shared.memo_lookup(0, q[1]) is None
        assert shared.memo_lookup(0, q[1], allow_stale=True) is not None
        _fence(eng.router)
        eng.start_session(0)
        before = shared.n_promoted
        turn = eng.answer_batch([0], [q[1]])[0]
        assert turn.tier == "l2_reuse" and turn.degraded
        assert shared.n_stale_served >= 1 and shared.n_promoted == before
        assert eng.telemetry.faults["stale_served"] >= 1


def test_engine_outage_with_cold_cache_still_fails(index, docs):
    eng = _engine(docs)
    with eng.router:
        _fence(eng.router)
        with pytest.raises(TimeoutError):
            eng.answer_batch([0], [queries_for(index, 1, seed=5)[0]])


# ------------------------------------------------------- cache-state guard
def test_validate_state_flags_each_corruption(index, docs):
    eng = _engine(docs, n_sessions=3)
    with eng.router:
        eng.answer_batch([0, 1, 2], list(queries_for(index, 3, seed=6)))
    st, cfg = eng.cache.state, eng.cache.cfg
    ok, problems = validate_state(st, cfg, n_corpus=N_DOCS)
    assert ok.all() and not problems
    for field, at, value, row in (("q_radius", (0, 0), np.nan, 0),
                                  ("doc_ids", (1, 0), N_DOCS + 7, 1),
                                  ("doc_emb", (2, 0, 0), np.inf, 2),
                                  ("n_docs", (0,), cfg.capacity + 1, 0)):
        bad = getattr(st, field).clone()
        bad[at] = value
        ok, _ = validate_state(st._replace(**{field: bad}), cfg,
                               n_corpus=N_DOCS)
        assert not ok[row] and ok.sum() == 2, field


def test_engine_quarantines_corrupt_slot_and_keeps_serving(index, docs):
    eng = _engine(docs, n_sessions=3, validate_every=1)
    with eng.router:
        eng.answer_batch([0, 1, 2], list(queries_for(index, 3, seed=7)))
        eng.cache.state.q_radius[1, 0] = float("nan")
        turns = eng.answer_batch([0, 1, 2], list(queries_for(index, 3,
                                                             seed=8)))
        assert all(isinstance(t, EngineTurn) for t in turns)
        assert eng.quarantined >= 1
        assert eng.telemetry.faults["quarantined_slots"] >= 1
        assert validate_state(eng.cache.state, eng.cache.cfg,
                              n_corpus=N_DOCS)[0].all()
        assert turns[1].tier == "backend" and not turns[1].hit


def test_validate_state_scalar_unbatched_state():
    cache = MetricCache(CacheConfig(capacity=32, dim=DIM + 1), "cpu")
    ok, problems = validate_state(cache.state, cache.cfg)
    assert bool(ok) and not problems


# ------------------------------------------------------- calls per wave
def test_shed_wave_is_two_calls(index, docs):
    """A full-miss wave is probe -> kNN -> insert+query; the load-shed wave
    that follows is probe -> cache query, nothing inserted."""
    router = ShardedRouter([DeviceShard(docs, np.arange(N_DOCS),
                                        device="cpu")],
                           deadline_s=120.0, n_docs=N_DOCS,
                           breaker_min_calls=2, breaker_cooldown_s=3600.0)
    eng = _engine(docs, router=router, epsilon=1e9)
    with router:
        dispatch.reset_counters()
        eng.answer_batch([0, 1], list(queries_for(index, 2, seed=9)))
        c = {n: v.calls for n, v in dispatch.counters().items() if v.calls}
        assert c == {"cache_probe": 1, "knn_score": 1, "knn_select": 1,
                     "wave_insert_query": 1}
        _fence(router)
        dispatch.reset_counters()
        turns = eng.answer_batch([0, 1], list(queries_for(index, 2,
                                                          seed=10)))
        c = {n: v.calls for n, v in dispatch.counters().items() if v.calls}
        assert c == {"cache_probe": 1, "wave_query_topk": 1}
        assert all(t.degraded for t in turns)


def test_scheduler_breaker_outage_recovery(index, docs):
    down = {"on": False}
    inner = make_shards(docs, 2)

    def flaky(queries, k, j=0):
        if down["on"]:
            raise RuntimeError("shard down")
        return inner[j](queries, k)

    router = ShardedRouter([lambda q, k, j=j: flaky(q, k, j)
                            for j in range(2)],
                           deadline_s=10.0, max_retries=1,
                           backoff_base_s=0.001, breaker_window=4,
                           breaker_min_calls=2, breaker_cooldown_s=0.2,
                           n_docs=N_DOCS)
    eng = _engine(docs, router=router)
    q = queries_for(index, 8, seed=11)
    with router, ContinuousScheduler(eng, window_s=60.0,
                                     adaptive=False) as sched:
        def wave(rows):
            return [f.result(timeout=120) for f in
                    [sched.submit(q[r], slot=s) for s, r in enumerate(rows)]]
        assert all(isinstance(t, EngineTurn) for t in wave([0, 1]))
        down["on"] = True
        assert all(t.degraded for t in wave([2, 3]))
        assert router.stats.breaker_opens >= 1
        assert all(t.degraded for t in wave([4, 5]))
        down["on"] = False
        time.sleep(0.25)
        deadline = time.monotonic() + 30.0
        while any(b.state != "closed" for b in router.breakers):
            wave([6, 7])
            time.sleep(0.25)
            assert time.monotonic() < deadline
        assert all(not t.degraded for t in wave([6, 7]))
        assert router.stats.breaker_closes >= 1
