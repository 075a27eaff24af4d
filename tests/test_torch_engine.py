"""The port's serving slice against the JAX package, on the CPU.

One ``DeviceShard`` corpus (the same transformed world in both packages)
behind a ``ShardedRouter``; 4 sessions x 4 turns of mixed hits and misses,
then a re-asked turn that every session answers from its cache.  The
port's ``BatchedEngine`` must give the JAX ``BatchedEngine(backend="ref")``
turn for turn: the same ids, hit and tier.  The op-call counters show the
wave contract: probe -> kNN -> insert+query for a wave with misses, probe
-> query for a wave without.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.embedding import transform_documents, transform_queries
from repro.data.conversations import WorldConfig, make_world
from repro.dist.retrieval import DeviceShard as JShard
from repro.serve.router import ShardedRouter as JRouter
from repro.serve.session import BatchedEngine as JEngine
from repro_torch.data.conversations import make_world as t_make_world
from repro_torch.dist.retrieval import DeviceShard
from repro_torch.kernels import dispatch
from repro_torch.serve.router import ShardedRouter
from repro_torch.serve.session import BatchedEngine, SessionManager

jax.config.update("jax_platform_name", "cpu")

WORLD = WorldConfig(n_topics=4, docs_per_topic=150, n_background=300,
                    dim=32, subspace_dim=6, turns=4, n_conversations=4,
                    doc_sigma=0.6, query_sigma=0.12, drift_sigma=0.16,
                    subtopic_prob=0.35, subtopic_sigma=0.75, seed=5)
KC, K, CAP = 60, 8, 400


@pytest.fixture(scope="module")
def world():
    w = make_world(WORLD)
    docs, _ = transform_documents(jnp.asarray(w.doc_emb, jnp.float32))
    streams = [np.asarray(transform_queries(jnp.asarray(c.queries,
                                                        jnp.float32)))
               for c in w.conversations]
    return w, np.array(docs), streams


def _waves(streams):
    """Turn t of every session forms wave t; the last wave re-asks the
    final turn, which every cache must answer."""
    n_turns = streams[0].shape[0]
    return [[s[t] for s in streams] for t in range(n_turns)] + \
        [[s[-1] for s in streams]]


def _op_calls():
    c = dispatch.counters()
    return (c["cache_probe"].calls + c["knn_score"].calls
            + c["wave_insert_query"].calls + c["wave_query_topk"].calls)


def test_world_copy_is_identical():
    a, b = make_world(WORLD), t_make_world(WORLD)
    np.testing.assert_array_equal(a.doc_emb, b.doc_emb)
    np.testing.assert_array_equal(a.conversations[2].queries,
                                  b.conversations[2].queries)


def test_radius_and_docs_matches_jax(world):
    """r_a from the last valid column of a sentinel-padded merge."""
    from repro.serve.engine import radius_and_docs as j_radius_and_docs
    from repro_torch.serve.engine import radius_and_docs

    _w, docs, _s = world
    scores = np.array([0.9, 0.7, 0.41, -np.inf, -np.inf], np.float32)
    ids = np.array([5, 17, 3, -1, -1])
    jr, jemb, jids = j_radius_and_docs(scores, ids, docs)
    tr, temb, tids = radius_and_docs(scores, ids, torch.as_tensor(docs))
    assert tr == jr
    np.testing.assert_array_equal(temb.numpy(), np.asarray(jemb))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    with pytest.raises(TimeoutError):
        radius_and_docs(scores[3:], ids[3:], torch.as_tensor(docs))


def test_batched_engine_turns_match_jax(world):
    _w, docs, streams = world
    ids = np.arange(docs.shape[0], dtype=np.int32)
    dim = docs.shape[1]
    with JRouter([JShard(docs, ids, backend="ref", dtype="fp32")],
                 deadline_s=30) as jr, \
            ShardedRouter([DeviceShard(docs, ids, device="cpu",
                                       dtype="fp32")], deadline_s=30) as tr:
        jeng = JEngine(jr, docs, dim=dim, n_sessions=4, k=K, k_c=KC,
                       capacity=CAP, backend="ref", dtype="fp32")
        teng = BatchedEngine(tr, docs, dim=dim, n_sessions=4, k=K, k_c=KC,
                             capacity=CAP, dtype="fp32", device="cpu")
        tiers = []
        for wave in _waves(streams):
            dispatch.reset_counters()
            jt = jeng.answer_batch(range(4), [jnp.asarray(q) for q in wave])
            tt = teng.answer_batch(range(4), [torch.as_tensor(q)
                                              for q in wave])
            for a, b in zip(jt, tt):
                np.testing.assert_array_equal(b.ids, a.ids)
                np.testing.assert_allclose(b.scores, a.scores, atol=1e-6)
                assert (b.hit, b.tier) == (a.hit, a.tier)
            misses = sum(t.tier == "backend" for t in tt)
            assert _op_calls() == (3 if misses else 2)
            tiers.append([t.tier for t in tt])
        assert any("l1" in w and "backend" in w for w in tiers[1:-1])
        assert tiers[0] == ["backend"] * 4 and tiers[-1] == ["l1"] * 4
        assert teng.hit_rate() == pytest.approx(jeng.hit_rate())


def test_session_manager_serves_waves(world):
    _w, docs, streams = world
    ids = np.arange(docs.shape[0], dtype=np.int32)
    with ShardedRouter([DeviceShard(docs, ids, device="cpu")],
                       deadline_s=30) as tr:
        eng = BatchedEngine(tr, docs, dim=docs.shape[1], n_sessions=4, k=K,
                            k_c=KC, capacity=CAP, device="cpu")
        ref = BatchedEngine(tr, docs, dim=docs.shape[1], n_sessions=4, k=K,
                            k_c=KC, capacity=CAP, device="cpu")
        with SessionManager(eng) as mgr:
            for key in range(4):
                mgr.open(key)
            for wave in _waves(streams):
                futs = [mgr.submit(key, q) for key, q in enumerate(wave)]
                got = [f.result(timeout=60) for f in futs]
                want = ref.answer_batch(range(4), wave)
                for a, b in zip(got, want):
                    np.testing.assert_array_equal(a.ids, b.ids)
                    assert a.tier == b.tier
        assert eng.hit_rate() == ref.hit_rate()


def test_recycled_slot_opens_empty_as_in_jax(world):
    """A key closed after two turns hands its slot to the next key opened:
    the reset row equals a fresh one, the other slot's row is untouched,
    the generation is bumped, and the new key's first turn (the old key's
    query, which the old cache holds) is a miss.  Every turn's decision
    and ids equal the JAX engine's on the same turns."""
    from repro_torch.core.cache_ops import init_cache

    _w, docs, streams = world
    ids = np.arange(docs.shape[0], dtype=np.int32)
    dim = docs.shape[1]
    q0, q1 = streams[0][0], streams[0][1]
    before = [("a", q0), ("a", q0), ("c", streams[1][0])]
    after = [("b", q0), ("b", q1), ("b", q1)]
    slot = {"a": 0, "c": 1, "b": 0}
    with JRouter([JShard(docs, ids, backend="ref", dtype="fp32")],
                 deadline_s=30) as jr, \
            ShardedRouter([DeviceShard(docs, ids, device="cpu",
                                       dtype="fp32")], deadline_s=30) as tr:
        jeng = JEngine(jr, docs, dim=dim, n_sessions=2, k=K, k_c=KC,
                       capacity=CAP, backend="ref", dtype="fp32")
        want = []
        for part, opened in ((before, (0, 1)), (after, (0,))):
            for s in opened:
                jeng.start_session(s)
            want += [jeng.answer_batch([slot[key]], [jnp.asarray(q)])[0]
                     for key, q in part]
        eng = BatchedEngine(tr, docs, dim=dim, n_sessions=2, k=K, k_c=KC,
                            capacity=CAP, dtype="fp32", device="cpu")
        fresh = init_cache(eng.cache.cfg, "cpu")
        with SessionManager(eng) as mgr:
            assert (mgr.open("a"), mgr.open("c")) == (0, 1)
            got = [mgr.submit(key, q).result(timeout=60)
                   for key, q in before]
            other = [x[1].clone() for x in eng.cache.state]
            mgr.close("a")
            assert mgr.open("b") == 0 and eng._gen.tolist() == [2, 1]
            for f, a, b in zip(fresh._fields, fresh, eng.cache.state):
                assert torch.equal(b[0], a), f
            got += [mgr.submit(key, q).result(timeout=60)
                    for key, q in after]
            for f, a, b in zip(fresh._fields, other, eng.cache.state):
                assert torch.equal(b[1], a), f
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.ids, a.ids)
        assert (b.hit, b.tier) == (a.hit, a.tier)
    assert [t.tier for t in got[:4]] == ["backend", "l1", "backend",
                                         "backend"]
    assert got[5].tier == "l1"


def test_two_shards_and_outage(world):
    """A corpus split over two shards answers as one shard does; with the
    back end down, warm sessions answer from their caches (degraded) and a
    session whose cache is empty fails alone."""
    from repro_torch.dist.retrieval import make_device_shards

    _w, docs, streams = world
    ids = np.arange(docs.shape[0], dtype=np.int32)
    down = {"on": False}

    def make(shards):
        def wrap(shard):
            def call(q, k):
                if down["on"]:
                    raise RuntimeError("shard down")
                return shard(q, k)
            return call
        return ShardedRouter([wrap(s) for s in shards], deadline_s=30,
                             max_retries=0)

    two = make_device_shards(docs, ids, devices=["cpu", "cpu"])
    assert [s.n_docs for s in two] == [450, 450]
    with make(two) as r2, make([DeviceShard(docs, ids, device="cpu")]) as r1:
        a = BatchedEngine(r2, docs, dim=docs.shape[1], n_sessions=4, k=K,
                          k_c=KC, capacity=CAP, device="cpu")
        b = BatchedEngine(r1, docs, dim=docs.shape[1], n_sessions=4, k=K,
                          k_c=KC, capacity=CAP, device="cpu")
        wave = [s[0] for s in streams[:3]]
        for x, y in zip(a.answer_batch(range(3), wave),
                        b.answer_batch(range(3), wave)):
            np.testing.assert_array_equal(x.ids, y.ids)
        down["on"] = True
        # session 1 asks the opposite of its first query: a sure miss
        out = a.answer_batch([0, 1, 3], [streams[0][0], -streams[1][0],
                                         streams[3][0]])
        assert isinstance(out[2], TimeoutError)           # empty cache
        assert (out[0].tier, out[0].degraded) == ("l1", False)
        assert (out[1].tier, out[1].degraded) == ("backend", True)
        assert len(out[1].ids) == K
        with pytest.raises(TimeoutError):
            a.answer_batch([3], [streams[3][0]])
