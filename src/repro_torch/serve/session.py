"""Session-batched serving: the paper's Algorithm 1 across concurrent sessions.

The port of ``repro.serve.session`` for the L1 session tier.
``BatchedEngine`` holds one stacked ``CacheState`` for S session slots on
one device and answers a wave of concurrent turns with

  * one ``probe_batched`` over the wave's cache rows       (launch 1),
  * one ``router.search`` for the whole miss subset, whose
    ``DeviceShard`` runs the fused kNN search             (launch 2),
  * one ``insert_query_batched`` — the gated insert fused with the answer
    query                                                  (launch 3);

a wave with no misses is probe -> ``query_batched``, two launches.  A wave
runs in three phases so ``ContinuousScheduler`` can overlap wave t+1's
probe with wave t's back-end search: ``probe_wave`` (touches cache state,
never writes it), ``backend_wave`` (router and shards only) and
``fill_wave`` (the fused insert+query, the scatter back, the turns).
A wave gathers and scatters back its sessions' small leaves (ids, stamps,
scales, the record ring, counters); the cache payload stays in the
stacked state, which the wave kernel reads and writes through the wave's
row index.

The corpus embeddings the engine inserts stay on the engine's device: a
wave gathers its k_c rows there, never through host memory.  The shared L2
tier and the cluster prefetch of the JAX engine are not part of this port
yet; passing ``shared=`` or ``cluster=`` raises.

``SessionManager`` is the asynchronous front door: session keys -> engine
slots, turns admitted into continuously scheduled waves, a Future per turn.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import quant
from repro_torch.core.cache import BatchedMetricCache
from repro_torch.core.cache_ops import (CacheConfig, CacheState,
                                        insert_query_batched, probe_batched,
                                        query_batched)
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.serve.engine import EngineTurn, radius_from_scores
from repro_torch.serve.router import ShardedRouter
from repro_torch.serve.scheduler import ContinuousScheduler
from repro_torch.serve.telemetry import ServeTelemetry, TurnSpans

__all__ = ["BatchedEngine", "SessionManager", "WaveState"]


@dataclasses.dataclass
class WaveState:
    """One wave in flight between the probe, backend and fill phases.

    Buffers are bucket-sized (the wave padded to its power-of-two bucket
    with copies of row 0); ``need`` marks the rows that still need the back
    end and ``tier`` the tier that answered each row.  A padded row never
    inserts or records, so it writes nothing.
    """

    sids: np.ndarray                 # (wave,) real session slots
    pad_sids: np.ndarray             # (bucket,) padded slot row
    wave: int
    bucket: int
    psi: torch.Tensor                # (bucket, dim) transformed queries
    psi_np: np.ndarray
    sub: CacheState                  # the wave's gathered rows; doc_emb
                                     # is the stacked payload
    rows: torch.Tensor               # (bucket,) int32 payload row per row
    need: np.ndarray                 # (bucket,) rows still needing backend
    tier: np.ndarray                 # (bucket,) serving tier per row
    new_ids: np.ndarray              # (bucket, k_c) insert ids
    new_emb: torch.Tensor            # (bucket, k_c, corpus width) on device
    rad: np.ndarray                  # (bucket,) claim radii
    rec_np: np.ndarray               # (bucket,) record the (psi, r_a) claim
    backend_ok: np.ndarray           # (bucket,) rows the backend answered
    failed: np.ndarray               # (bucket,) empty-cache outage rows
    admitted_at: np.ndarray          # (wave,) perf_counter admission stamps
    t_start: float                   # wave (probe-phase) start stamp
    degraded: bool = False
    outage: Optional[BaseException] = None
    probe_s: float = 0.0
    backend_s: float = 0.0


class BatchedEngine:
    """S concurrent client sessions over one stacked metric cache.

    ``doc_embeddings`` (N, width >= dim) are the transformed corpus rows the
    engine inserts, moved to ``device`` once (None means ``cuda``; a tensor
    already there is used without a copy, so it can share storage with the
    shard's corpus).  ``dtype`` is the cache storage format (None follows
    ``REPRO_CORPUS_DTYPE``).
    """

    def __init__(self, router: ShardedRouter, doc_embeddings, *, dim: int,
                 n_sessions: int, k: int = 10, k_c: int = 1000,
                 epsilon: float = 0.04, capacity: Optional[int] = None,
                 encoder: Optional[Callable] = None,
                 dtype: Optional[str] = None,
                 shared=None, cluster=None,
                 telemetry: Optional[ServeTelemetry] = None, device=None):
        if shared is not None or cluster is not None:
            raise NotImplementedError(
                "the shared L2 tier and cluster prefetch are not ported yet")
        self.device = resolve_device(device)
        self.router = router
        self.doc_embeddings = torch.as_tensor(doc_embeddings,
                                              device=self.device)
        self.n_sessions = n_sessions
        self.k, self.k_c, self.epsilon = k, k_c, epsilon
        self.encoder = encoder
        self.cache = BatchedMetricCache(CacheConfig(
            capacity=capacity or 16 * k_c, dim=dim, epsilon=epsilon,
            store_dtype=quant.resolve_dtype(dtype)), n_sessions, self.device)
        self.telemetry = telemetry if telemetry is not None \
            else ServeTelemetry()
        self.turns: list[list[EngineTurn]] = [[] for _ in range(n_sessions)]

    def start_session(self, session: int):
        self.cache.reset([session])
        self.turns[session] = []

    def _bucket(self, n: int) -> int:
        """Wave sizes padded to powers of two (capped at n_sessions), the
        JAX engine's wave shapes."""
        b = 1
        while b < n:
            b *= 2
        return min(b, self.n_sessions)

    # ------------------------------------------------------- probe phase
    def probe_wave(self, sessions, queries,
                   admitted_at: Optional[Sequence[float]] = None
                   ) -> WaveState:
        """Phase 1: encoder + L1 probe over the wave's gathered cache rows
        (every leaf but the payload).  Never writes the stacked state."""
        t_start = time.perf_counter()
        sids = np.asarray(sessions, np.int32)
        if np.unique(sids).size != sids.size:
            raise ValueError("one turn per session per wave")
        wave = len(sids)
        bucket = self._bucket(wave)
        admitted = (np.full((wave,), t_start, np.float64)
                    if admitted_at is None
                    else np.asarray(admitted_at, np.float64))
        pad_sids = np.concatenate([sids, np.repeat(sids[:1], bucket - wave)])
        q = torch.stack([torch.as_tensor(np.asarray(x), device=self.device)
                         for x in queries])
        q = torch.cat([q, q[:1].expand((bucket - wave,) + q.shape[1:])])
        psi = (self.encoder(q) if self.encoder else q).to(torch.float32)

        sub = self.cache.gather(pad_sids, payload=False)
        # launch 1: the L1 LowQuality probe over the wave's session rows
        pr = probe_batched(sub, psi, self.epsilon,
                           max_queries=self.cache.cfg.max_queries)
        n_queries = sub.n_queries.cpu().numpy()
        need = np.logical_or(n_queries == 0, ~pr.hit.cpu().numpy())
        need[wave:] = False
        tier = np.where(need, "backend", "l1").astype(object)
        ws = WaveState(
            sids=sids, pad_sids=pad_sids, wave=wave, bucket=bucket,
            psi=psi, psi_np=psi.cpu().numpy(), sub=sub,
            rows=self.cache.wave_rows(pad_sids), need=need, tier=tier,
            new_ids=np.full((bucket, self.k_c), -1, np.int64),
            new_emb=torch.zeros((bucket, self.k_c,
                                 self.doc_embeddings.shape[1]),
                                dtype=self.doc_embeddings.dtype,
                                device=self.device),
            rad=np.zeros((bucket,), np.float32),
            rec_np=np.zeros((bucket,), bool),
            backend_ok=np.zeros((bucket,), bool),
            failed=np.zeros((bucket,), bool),
            admitted_at=admitted, t_start=t_start)
        ws.probe_s = time.perf_counter() - t_start
        return ws

    # ----------------------------------------------------- backend phase
    def backend_wave(self, ws: WaveState) -> WaveState:
        """Phase 2: ``router.search`` over the miss subset (launch 2 runs
        inside the router's shards).  A total back-end failure marks the
        empty-cache miss rows failed and raises only when every real row is
        in that state; a fenced back end (every breaker open) load-sheds
        the wave."""
        t0 = time.perf_counter()
        need, wave = ws.need, ws.wave
        try:
            if need.any():
                if getattr(self.router, "backend_open", False):
                    self.telemetry.record_fault("shed_waves")
                    self.telemetry.record_fault(
                        "shed_turns", int(need[:wave].sum()))
                    self._outage_fallback(ws, TimeoutError(
                        "back end fenced: load-shed wave"))
                    if ws.failed[:wave].all():
                        raise ws.outage
                    return ws
                miss = np.nonzero(need)[0]
                try:
                    ans, degraded = self.router.search(
                        ws.psi_np[miss], self.k_c)
                    ws.degraded = degraded
                    n_valid = (ans.ids >= 0).sum(axis=1)
                    if (n_valid == 0).any():
                        raise TimeoutError(
                            "back-end answer holds no valid docs")
                    # r_a from the last VALID column of each row
                    radii = radius_from_scores(np.take_along_axis(
                        ans.scores, n_valid[:, None] - 1, axis=1)[:, 0])
                    ws.new_ids[miss] = ans.ids
                    idx = torch.as_tensor(np.maximum(ans.ids, 0),
                                          device=self.device)
                    ws.new_emb[torch.as_tensor(miss, device=self.device)] = \
                        self.doc_embeddings[idx]
                    ws.rad[miss] = radii
                    # a degraded merge misses shards: keep the docs, skip
                    # the (psi, r_a) record so no cache learns a false claim
                    ws.rec_np[miss] = not degraded
                    ws.backend_ok = need.copy()
                except TimeoutError as e:
                    self._outage_fallback(ws, e)
                    if ws.failed[:wave].all():
                        raise
            return ws
        finally:
            ws.backend_s = time.perf_counter() - t0

    def _outage_fallback(self, ws: WaveState, e: BaseException) -> None:
        """A shed or failed search: warm-cache rows answer from their caches
        (the fill phase's query path), empty-cache rows fail."""
        ws.degraded = True
        ws.outage = e
        ws.failed = np.logical_and(ws.need, ws.sub.n_docs.cpu().numpy() == 0)

    # -------------------------------------------------------- fill phase
    def fill_wave(self, ws: WaveState) -> list:
        """Phase 3: the fused insert+query launch (or the query launch of a
        missless wave) on the stacked payload, the scatter back of the small
        leaves, and one ``EngineTurn`` per real session in input order (a
        ``TimeoutError`` for a failed one)."""
        t0 = time.perf_counter()
        fill = ws.backend_ok
        if fill.any():
            # launch 3 of 3: insert + answer query, fused
            (scores, _dists, ids, _slots), sub, dropped = \
                insert_query_batched(
                    ws.sub, self.cache.cfg, ws.psi, torch.as_tensor(ws.rad),
                    ws.new_emb, torch.as_tensor(ws.new_ids), self.k,
                    do=torch.as_tensor(fill), record=torch.as_tensor(ws.rec_np),
                    rows=ws.rows)
            self.cache.total_dropped += int(dropped.sum())
        else:   # missless (or outage) wave: probe -> query
            (scores, _dists, ids, _slots), sub = query_batched(
                ws.sub, ws.psi, self.k, rows=ws.rows)
        able = np.nonzero(~ws.failed[:ws.wave])[0]
        # write back only real, answerable rows (padded rows shadow row 0)
        self.cache.scatter(ws.sids[able], sub,
                           rows=torch.as_tensor(able, device=self.device))
        ids_np, scores_np = ids.cpu().numpy(), scores.cpu().numpy()

        resolved = time.perf_counter()
        insert_s = resolved - t0
        out: list = []
        for i, s in enumerate(ws.sids):
            if ws.failed[i]:
                self.telemetry.record_fault("failed_turns")
                out.append(TimeoutError(
                    f"session {int(s)}: back-end down and cache empty"
                    f" ({ws.outage})"))
                continue
            real = ids_np[i] >= 0
            row_tier = str(ws.tier[i])
            spans = TurnSpans(
                queue_wait_s=max(ws.t_start - float(ws.admitted_at[i]), 0.0),
                probe_s=ws.probe_s, backend_s=ws.backend_s,
                insert_s=insert_s,
                total_s=resolved - float(ws.admitted_at[i]), tier=row_tier)
            turn = EngineTurn(ids=ids_np[i][real], scores=scores_np[i][real],
                              hit=row_tier != "backend",
                              degraded=bool(ws.degraded
                                            and row_tier == "backend"),
                              latency_s=spans.total_s, tier=row_tier,
                              queue_wait_s=spans.queue_wait_s, spans=spans)
            if turn.degraded:
                self.telemetry.record_fault("degraded_turns")
            self.telemetry.record_turn(spans)
            self.turns[int(s)].append(turn)
            out.append(turn)
        return out

    def answer_batch(self, sessions, queries) -> list:
        """One concurrent turn per listed session, inline: probe -> backend
        -> fill."""
        ws = self.probe_wave(sessions, queries)
        self.backend_wave(ws)
        return self.fill_wave(ws)

    def hit_rate(self, session: Optional[int] = None) -> float:
        """Cache hit rate, excluding each session's compulsory first turn
        (one session's, or the aggregate over all sessions)."""
        if session is not None:
            turns = self.turns[session]
            if len(turns) <= 1:
                return float("nan")
            return float(np.mean([t.hit for t in turns[1:]]))
        flags = [t.hit for turns in self.turns for t in turns[1:]]
        return float(np.mean(flags)) if flags else float("nan")

    def tier_counts(self, skip_first: bool = True) -> dict:
        """Turns served per tier (``l1`` / ``backend``)."""
        counts = {"l1": 0, "backend": 0}
        for turns in self.turns:
            for t in (turns[1:] if skip_first else turns):
                counts[t.tier] += 1
        return counts


class SessionManager:
    """Asynchronous front door: session keys -> engine slots -> waves.

    ``submit(key, query)`` returns a Future[EngineTurn]; turns are admitted
    into continuously scheduled ``BatchedEngine`` waves by a
    ``ContinuousScheduler``.  Two turns of one session are never in flight
    together.  A context manager: leaving it drains and stops the worker.
    """

    def __init__(self, engine: BatchedEngine, *, window_s: float = 0.0,
                 max_batch: Optional[int] = None, min_slots: int = 1,
                 max_slots: Optional[int] = None,
                 adaptive: Optional[bool] = None, headroom: float = 1.5,
                 ewma_horizon_s: float = 1.0,
                 target_p99_s: Optional[float] = None,
                 overlap: bool = True):
        self.engine = engine
        self._slots: dict = {}
        self._free = list(range(engine.n_sessions - 1, -1, -1))
        self.scheduler = ContinuousScheduler(
            engine, min_wave=min_slots,
            max_wave=max_slots or max_batch or engine.n_sessions,
            window_s=window_s, adaptive=adaptive, headroom=headroom,
            ewma_horizon_s=ewma_horizon_s, target_p99_s=target_p99_s,
            overlap=overlap)

    @property
    def batcher(self) -> ContinuousScheduler:
        """Alias of ``scheduler`` (the reference's earlier name)."""
        return self.scheduler

    @property
    def telemetry(self) -> ServeTelemetry:
        return self.scheduler.telemetry

    def open(self, key) -> int:
        """Start a session for ``key``; returns its engine slot."""
        if key in self._slots:
            raise KeyError(f"session {key!r} already open")
        if not self._free:
            raise RuntimeError("no free session slots")
        slot = self._free.pop()
        self.engine.start_session(slot)
        self._slots[key] = slot
        return slot

    def close(self, key):
        """End a session and recycle its slot after draining only this
        key's pending turns."""
        if key not in self._slots:
            raise KeyError(f"unknown session key {key!r}")
        self.scheduler.drain_slot(self._slots[key])
        self._free.append(self._slots.pop(key))

    def shutdown(self):
        """Drain pending turns and stop the scheduler's worker (idempotent)."""
        self.scheduler.close()

    def __enter__(self) -> "SessionManager":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.shutdown()
        return False

    @property
    def active_sessions(self) -> int:
        return len(self._slots)

    def submit(self, key, query):
        """Admit one turn; returns a Future resolved with its EngineTurn."""
        return self.scheduler.submit(query, slot=self._slots[key])

    def flush(self):
        """Force everything queued now to execute."""
        self.scheduler.flush()
