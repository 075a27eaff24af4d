"""The serving path's span log (``repro_torch.serve.telemetry``), on the CPU.

A small world behind one ``DeviceShard`` and a ``ShardedRouter``, served
by ``BatchedEngine`` waves inline and through ``SessionManager`` (the
scheduler's worker, its back-end thread and the router's pool).  The
spans must nest, name their parents across those threads, carry their
wave's id there, and give ``TurnSpans`` the values they always had; the
ring must refuse a window it has overwritten; a span must build a
profiler range only while a profiler runs.
"""

import threading

import numpy as np
import pytest
import torch

from repro_torch.core.embedding import transform_documents, transform_queries
from repro_torch.data.conversations import WorldConfig, make_world
from repro_torch.dist.retrieval import DeviceShard
from repro_torch.serve import telemetry
from repro_torch.serve.router import ShardedRouter
from repro_torch.serve.session import BatchedEngine, SessionManager
from repro_torch.serve.telemetry import (SPANS, ServeTelemetry, SpanLog,
                                         TurnSpans)

WORLD = WorldConfig(n_topics=4, docs_per_topic=150, n_background=300,
                    dim=32, subspace_dim=6, turns=4, n_conversations=4,
                    doc_sigma=0.6, query_sigma=0.12, drift_sigma=0.16,
                    subtopic_prob=0.35, subtopic_sigma=0.75, seed=5)
KC, K, CAP = 60, 8, 400


@pytest.fixture(scope="module")
def world():
    w = make_world(WORLD)
    docs, _ = transform_documents(torch.as_tensor(w.doc_emb,
                                                  dtype=torch.float32))
    streams = [transform_queries(torch.as_tensor(c.queries,
                                                 dtype=torch.float32)).numpy()
               for c in w.conversations]
    return docs.numpy(), streams


def _engine(router, docs, telemetry_=None):
    return BatchedEngine(router, docs, dim=docs.shape[1], n_sessions=4, k=K,
                         k_c=KC, capacity=CAP, device="cpu",
                         telemetry=telemetry_)


class _Clock:
    """A stand-in for the span log's clock that advances by ``step`` ns a
    read."""

    def __init__(self, step=1000):
        self.t, self.step = 0, step

    def __call__(self):
        self.t += self.step
        return self.t


def _spans_of(sp, name):
    return np.nonzero(sp.of(name))[0]


def _by_token(sp):
    return {int(t): i for i, t in enumerate(sp.token)}


def test_spans_nest_and_carry_the_wave_across_threads(world):
    docs, streams = world
    ids = np.arange(docs.shape[0], dtype=np.int32)
    t0 = SPANS._start.max()
    with ShardedRouter([DeviceShard(docs, ids, device="cpu")],
                       deadline_s=30) as router:
        with SessionManager(_engine(router, docs)) as mgr:
            for key in range(4):
                mgr.open(key)
            for t in range(2):
                futs = [mgr.submit(key, streams[key][t]) for key in range(4)]
                [f.result(timeout=60) for f in futs]
    sp = SPANS.window(int(t0) + 1, 2 ** 62)
    pos = _by_token(sp)
    worker = {int(sp.thread[i]) for i in _spans_of(sp, "serve.probe_wave")}
    assert len(worker) == 1
    waves = sp.wave[_spans_of(sp, "serve.probe_wave")]
    assert len(set(waves.tolist())) == len(waves) >= 2 and (waves >= 0).all()
    for name in ("serve.encode", "serve.probe", "serve.sync.queries",
                 "serve.sync.gather_idx", "serve.sync.probe_hit"):
        for i in _spans_of(sp, name):
            # children of the probe phase, on the worker, in its wave
            p = pos[int(sp.parent[i])]
            while sp.names[sp.kind[p]] != "serve.probe_wave":
                p = pos[int(sp.parent[p])]
            assert sp.wave[i] == sp.wave[p] and sp.thread[i] in worker
    scans = _spans_of(sp, "serve.scan")
    assert len(scans) >= 1
    for i in scans:
        search = pos[int(sp.parent[i])]
        assert sp.names[sp.kind[search]] == "serve.search"
        backend = pos[int(sp.parent[search])]
        assert sp.names[sp.kind[backend]] == "serve.backend_wave"
        # three threads: the router's pool, the back-end thread, the worker
        assert len({int(sp.thread[i]), int(sp.thread[search])}
                   | worker) == 3
        assert sp.thread[backend] == sp.thread[search]
        assert sp.wave[i] == sp.wave[search] == sp.wave[backend] >= 0
        assert sp.start[backend] <= sp.start[search] <= sp.start[i]
        assert sp.end[i] <= sp.end[search] <= sp.end[backend]
        kids = [j for j in range(len(sp.token))
                if sp.parent[j] == sp.token[i]]
        assert {sp.names[sp.kind[j]] for j in kids} == {
            "serve.sync.shard_queries", "serve.sync.shard_scores",
            "serve.sync.shard_ids"}
        assert all(sp.wave[j] == sp.wave[i] for j in kids)
    for name in ("serve.join_backend", "serve.deliver", "serve.fill_wave"):
        got = sp.wave[_spans_of(sp, name)]
        assert set(got.tolist()) <= set(waves.tolist()) and len(got)
    for i in _spans_of(sp, "serve.open"):
        assert sp.wave[i] == -1
    # every span on the worker lies inside a pass of its loop
    top = [i for i in range(len(sp.token))
           if sp.thread[i] in worker and sp.parent[i] == -1]
    assert {sp.names[sp.kind[i]] for i in top} <= {"serve.loop", "serve.gc"}
    loops = {int(sp.token[i]) for i in top
             if sp.names[sp.kind[i]] == "serve.loop"}
    for name in ("serve.await_turns", "serve.probe_wave",
                 "serve.join_backend", "serve.fill_wave", "serve.deliver"):
        assert all(int(sp.parent[i]) in loops for i in _spans_of(sp, name))


def test_turn_spans_read_the_phase_spans(world):
    docs, streams = world
    ids = np.arange(docs.shape[0], dtype=np.int32)
    with ShardedRouter([DeviceShard(docs, ids, device="cpu")],
                       deadline_s=30) as router:
        eng = _engine(router, docs)
        for s in range(4):
            eng.start_session(s)
        for t in range(3):
            t0 = SPANS._start.max()
            admitted = [float(t0) * 1e-9 - 0.001 * (s + 1) for s in range(4)]
            ws = eng.probe_wave(range(4), [streams[s][t] for s in range(4)],
                                admitted_at=admitted)
            eng.backend_wave(ws)
            turns = eng.fill_wave(ws)
            sp = SPANS.window(int(t0) + 1, 2 ** 62)
            one = lambda n: int(_spans_of(sp, n)[-1])  # noqa: E731
            probe, back, fill, res = (one("serve.probe_wave"),
                                      one("serve.backend_wave"),
                                      one("serve.fill_wave"),
                                      one("serve.resolve"))
            sec = lambda i: (int(sp.end[i]) - int(sp.start[i])) * 1e-9  # noqa
            start = lambda i: int(sp.start[i]) * 1e-9  # noqa: E731
            for s, turn in enumerate(turns):
                want = TurnSpans(
                    queue_wait_s=max(start(probe) - admitted[s], 0.0),
                    probe_s=sec(probe), backend_s=sec(back),
                    insert_s=start(res) - start(fill),
                    total_s=start(res) - admitted[s], tier=turn.tier)
                assert turn.spans == want
                assert turn.latency_s == want.total_s
                assert turn.queue_wait_s == want.queue_wait_s
                assert want.total_s >= want.queue_wait_s + want.probe_s > 0


def test_ring_refuses_a_window_it_overwrote(monkeypatch):
    monkeypatch.setattr(telemetry, "_clock", _Clock())
    log = SpanLog(capacity=8)
    a = log.kind("serve.a")
    for _ in range(6):
        with a:
            pass
    first = int(log.all().start.min())
    assert len(log.window(first, 2 ** 62).token) == 6
    for _ in range(6):                      # 12 spans into 8 slots
        with a:
            pass
    assert log.window(first, 2 ** 62) is None
    held = log.all()
    assert len(held.token) == 8 and list(held.token) == list(range(4, 12))
    assert len(log.window(int(held.start.min()), 2 ** 62).token) == 8
    # a span overwritten while open leaves its thread with no parent
    with a:
        tok = log.current()
        for _ in range(8):
            with a:
                pass
    assert log.current() == -1 and np.isnan(log.duration_s(tok))


def test_of_names_the_wave_and_the_parent_restores_it(monkeypatch):
    monkeypatch.setattr(telemetry, "_clock", _Clock())
    log = SpanLog(capacity=64)
    a, b = log.kind("serve.a"), log.kind("serve.b")
    with a.of(7) as ta:
        with b as tb:
            pass
        with b.of(9) as tc:
            pass
        assert log.current() == ta and log._tls.wave == 7
    assert log.current() == -1 and log._tls.wave == -1
    sp = log.all()
    pos = _by_token(sp)
    assert sp.wave[pos[tb]] == 7 and sp.parent[pos[tb]] == ta
    assert sp.wave[pos[tc]] == 9 and sp.parent[pos[tc]] == ta
    # work adopted on another thread belongs to the adopting span
    seen = {}

    def other():
        log.adopt(tc)
        with b as t:
            seen["tok"] = t
        log.adopt(-1)
        seen["after"] = (log.current(), log._tls.wave)

    th = threading.Thread(target=other)
    th.start()
    th.join()
    sp = log.all()
    i = _by_token(sp)[seen["tok"]]
    assert sp.parent[i] == tc and sp.wave[i] == 9
    assert sp.thread[i] != sp.thread[pos[tc]]
    assert seen["after"] == (-1, -1)


def test_a_profiler_range_only_while_a_profiler_runs(monkeypatch):
    opened = []
    real = telemetry._open_range

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(telemetry, "_open_range", counting)
    log = SpanLog(capacity=64)
    a, b = log.kind("serve.a"), log.kind("serve.sync.b", telemetry.SyncSite)
    for _ in range(5):
        with a:
            b.host(torch.ones(3))
    assert [n for n in opened if n != "serve.gc"] == [] \
        and log._ranges == {}
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with a:
                b.host(torch.ones(3))
    # (a pass of the collector in between records serve.gc in SPANS)
    assert [n for n in opened if n != "serve.gc"] == \
        ["serve.a", "serve.sync.b"] * 3 and log._ranges == {}
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("serve.a") == 3 and names.count("serve.sync.b") == 3


def test_summary_rests_on_the_span_log(monkeypatch):
    clock = _Clock(step=1_000_000)
    monkeypatch.setattr(telemetry, "_clock", clock)
    log = SpanLog(capacity=64)
    a, b = log.kind("serve.a"), log.kind("serve.b")
    for n in range(1, 11):      # serve.a lasts n + 1 clock steps
        with a:
            for _ in range(n):
                clock()
    with b:
        pass
    s = log.summary()
    assert set(s) == {"serve.a", "serve.b"}
    assert s["serve.a"]["count"] == 10
    assert s["serve.a"]["p50"] == pytest.approx(6e-3)
    assert s["serve.a"]["p95"] == pytest.approx(11e-3)
    assert s["serve.b"] == {"count": 1, "p50": 1e-3, "p95": 1e-3,
                            "p99": 1e-3}
    monkeypatch.setattr(telemetry, "SPANS", log)
    tel = ServeTelemetry()
    tel.record_turn(TurnSpans(total_s=0.065, tier="backend"))
    tel.record_turn(TurnSpans(total_s=0.004, tier="l1"))
    tel.record_wave(2, 0.06)
    tel.record_fault("shed_waves")
    out = tel.summary()
    assert set(out) == {"turns", "waves", "arrival_rate_hz", "turn_total_s",
                        "spans", "faults", "breaker_transitions",
                        "expert_load", "encoder_graphs"}
    # the dropless MoE path's counter and the query encoder's graph
    # counts, the process's as the span log is
    assert out["expert_load"] == telemetry.EXPERT_LOAD.summary()
    assert out["encoder_graphs"] == telemetry.ENCODER_GRAPHS.summary()
    assert out["turns"] == 2 and out["waves"] == 1
    assert out["turn_total_s"]["p99"] == 0.065
    assert out["spans"] == s and out["faults"] == {"shed_waves": 1}
    assert not hasattr(tel, "tier_total") and not hasattr(tel, "wave_sizes")


def test_threads_record_spans_without_losing_one():
    """More threads than cores, switching often: every span is kept once,
    with its own thread's parent and wave."""
    import os
    import sys

    log = SpanLog(capacity=1 << 16)
    outer, inner = log.kind("serve.a"), log.kind("serve.b")
    n_threads, per = 4 * (os.cpu_count() or 1), 200

    def work(w):
        for _ in range(per):
            with outer.of(w):
                with inner:
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(w,))
                   for w in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    sp = log.all()
    assert len(sp.token) == 2 * n_threads * per
    assert len(set(sp.token.tolist())) == len(sp.token)
    pos = _by_token(sp)
    kids = np.nonzero(sp.of("serve.b"))[0]
    assert len(kids) == n_threads * per
    for i in kids:
        p = pos[int(sp.parent[i])]
        assert sp.names[sp.kind[p]] == "serve.a"
        assert sp.thread[p] == sp.thread[i] and sp.wave[p] == sp.wave[i]
        assert sp.start[p] <= sp.start[i] <= sp.end[i] <= sp.end[p]
    assert (sp.parent[sp.of("serve.a")] == -1).all()
    for w in range(n_threads):
        assert ((sp.wave == w) & sp.of("serve.a")).sum() == per
