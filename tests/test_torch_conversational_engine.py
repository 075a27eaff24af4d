"""The port's single-session ``ConversationalEngine`` against the JAX one.

Both engines sit behind their package's ``ShardedRouter`` over the same
transformed corpus (JAX shards on the jnp reference, the port's
``DeviceShard`` on CPU tensors).  Turn for turn the hit, tier, degraded
flag and ids are equal and scores agree within 1e-6.  The resilience
paths are driven with shards that raise: a degraded merge (one shard of
two down) inserts its documents without the (psi, r_a) record, a total
back-end failure is answered from a non-empty cache, and an empty cache
under a total failure raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.embedding import transform_documents, transform_queries
from repro.data.conversations import WorldConfig, make_world
from repro.dist.retrieval import DeviceShard as JShard
from repro.serve.engine import ConversationalEngine as JEngine
from repro.serve.router import ShardedRouter as JRouter
from repro_torch.dist.retrieval import DeviceShard
from repro_torch.kernels import dispatch
from repro_torch.serve import ConversationalEngine, ShardedRouter

jax.config.update("jax_platform_name", "cpu")

WORLD = WorldConfig(n_topics=4, docs_per_topic=150, n_background=300,
                    dim=32, subspace_dim=6, turns=5, n_conversations=3,
                    doc_sigma=0.6, query_sigma=0.12, drift_sigma=0.16,
                    subtopic_prob=0.35, subtopic_sigma=0.75, seed=5)
K, KC, CAP = 8, 60, 400


@pytest.fixture(scope="module")
def world():
    w = make_world(WORLD)
    docs, _ = transform_documents(jnp.asarray(w.doc_emb, jnp.float32))
    streams = [np.asarray(transform_queries(jnp.asarray(c.queries,
                                                        jnp.float32)))
               for c in w.conversations]
    return np.array(docs), streams


def _switchable(shard, down, i):
    def call(q, k):
        if down[i]:
            raise RuntimeError(f"shard {i} down")
        return shard(q, k)
    return call


def _routers(docs, n_shards, down):
    ids = np.arange(docs.shape[0], dtype=np.int32)
    per = -(-docs.shape[0] // n_shards)
    cuts = [(lo, lo + per) for lo in range(0, docs.shape[0], per)]
    jr = JRouter([_switchable(JShard(docs[a:b], ids[a:b], backend="ref",
                                     dtype="fp32"), down, i)
                  for i, (a, b) in enumerate(cuts)],
                 deadline_s=30, max_retries=0)
    tr = ShardedRouter([_switchable(DeviceShard(docs[a:b], ids[a:b],
                                                device="cpu", dtype="fp32"),
                                    down, i)
                        for i, (a, b) in enumerate(cuts)],
                       deadline_s=30, max_retries=0)
    return jr, tr


def _engines(jr, tr, docs):
    kw = dict(dim=docs.shape[1], k=K, k_c=KC, epsilon=0.04, capacity=CAP,
              dtype="fp32")
    return JEngine(jr, docs, **kw), ConversationalEngine(tr, docs,
                                                         device="cpu", **kw)


def _same(a, b, what):
    assert (b.hit, b.tier, b.degraded) == (a.hit, a.tier, a.degraded), what
    np.testing.assert_array_equal(b.ids, np.asarray(a.ids), err_msg=what)
    np.testing.assert_allclose(b.scores, np.asarray(a.scores), atol=1e-6,
                               rtol=0, err_msg=what)


def test_engine_turns_match_jax(world):
    docs, streams = world
    down = [False]
    jr, tr = _routers(docs, 1, down)
    with jr, tr:
        je, te = _engines(jr, tr, docs)
        tiers = []
        for c, stream in enumerate(streams):
            je.start_session()
            te.start_session()
            for t, q in enumerate(stream):
                dispatch.reset_counters()
                a, b = je.answer(jnp.asarray(q)), te.answer(torch.tensor(q))
                _same(a, b, f"conversation {c} turn {t}")
                calls = dispatch.counters()
                miss = int(b.tier == "backend")
                assert (calls["probe_rhat"].calls,
                        calls["wave_query_topk"].calls,
                        calls["knn_score"].calls,
                        calls["wave_insert_scatter"].calls) == \
                    (1, 1, miss, miss)
                tiers.append(b.tier)
            assert te.hit_rate() == je.hit_rate()
        assert "l1" in tiers and "backend" in tiers[1:]


def test_degraded_and_outage_paths_match_jax(world):
    docs, streams = world
    down = [False, False]
    jr, tr = _routers(docs, 2, down)
    with jr, tr:
        je, te = _engines(jr, tr, docs)
        q0, q1 = streams[0][0], streams[1][0]
        _same(je.answer(jnp.asarray(q0)), te.answer(torch.tensor(q0)),
              "healthy miss")
        assert te.cache.n_queries == 1
        # one shard down: a degraded merge keeps its docs, not its claim
        down[1] = True
        before = te.cache.n_docs
        a, b = je.answer(jnp.asarray(-q0)), te.answer(torch.tensor(-q0))
        _same(a, b, "degraded miss")
        assert b.degraded and b.tier == "backend"
        assert te.cache.n_queries == je.cache.n_queries == 1
        assert te.cache.n_docs == je.cache.n_docs > before
        # every shard down: the warm cache answers a sure miss
        down[0] = True
        a, b = je.answer(jnp.asarray(q1)), te.answer(torch.tensor(q1))
        _same(a, b, "outage miss")
        assert b.degraded and not b.hit and len(b.ids) == K
        # a cold engine under a total outage raises
        je2, te2 = _engines(jr, tr, docs)
        with pytest.raises(TimeoutError):
            je2.answer(jnp.asarray(q0))
        with pytest.raises(TimeoutError):
            te2.answer(torch.tensor(q0))


def test_short_cache_answers_drop_sentinels(world):
    """A cache holding fewer than k docs: both engines drop the (-1, -inf)
    sentinel slots from the turn."""
    docs, streams = world
    down = [False]
    jr, tr = _routers(docs, 1, down)
    with jr, tr:
        kw = dict(dim=docs.shape[1], k=K, k_c=5, epsilon=0.04, capacity=50,
                  dtype="fp32")
        je = JEngine(jr, docs, **kw)
        te = ConversationalEngine(tr, docs, device="cpu", **kw)
        q = streams[2][0]
        a, b = je.answer(jnp.asarray(q)), te.answer(torch.tensor(q))
        _same(a, b, "short cache")
        assert len(b.ids) == 5 and (b.ids >= 0).all()
