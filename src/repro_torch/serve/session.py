"""Session-batched serving: the paper's Algorithm 1 across concurrent sessions.

The port of ``repro.serve.session``.  ``BatchedEngine`` holds one stacked
``CacheState`` for S session slots on one device and answers a wave of
concurrent turns with

  * one ``probe_batched`` over the wave's cache rows       (launch 1),
  * one ``router.search`` for the whole miss subset, whose
    ``DeviceShard`` runs the fused kNN search             (launch 2),
  * one ``insert_query_batched`` — the gated insert fused with the answer
    query                                                  (launch 3);

a wave with no misses is probe -> ``query_batched``, two launches.  A wave
runs in three phases so ``ContinuousScheduler`` can overlap wave t+1's
probe with wave t's back-end search: ``probe_wave`` (touches cache state,
never writes L1), ``backend_wave`` (router and shards only) and
``fill_wave`` (the fused insert+query, the scatter back, the admission
flush, the turns).  A wave gathers and scatters back its sessions' small
leaves (ids, stamps, scales, the record ring, counters); the cache
payload stays in the stacked state, which the wave kernel reads and
writes through the wave's row index.

**Cache hierarchy.**  With a ``core.shared.SharedTier`` attached the miss
wave is tiered: L1 probe -> L2 memo (host) -> L2 probe over the gathered
shard rows (launch 2) -> back-end kNN on the residual misses (launch 3)
-> the fused insert+query (launch 4).  An L2 answer query adds a launch
only when some row hits L2; the end-of-wave admission flush is one
``wave_insert_scatter`` per sub-wave, only when answers were promoted.
Tier-served answers warm L1 through the same fused launch, recording a
claim only when it is sound (fresh un-degraded back-end radii, or the
memo's triangle-corrected Eq. 3 claim).

**Cluster prefetch.**  With a ``core.cluster.ClusterIndex`` and
``prefetch_width`` m, each fresh back-end answer is widened by the m
documents nearest its cluster's centroid inside the same fused insert
(buffers k_c + m wide), and the recorded claim becomes ``max(r_a, d_m -
||psi - c||)`` (triangle inequality).

**Degradation ladder.**  A shed or failed back-end search serves a warm
cache from its cache, an empty one stale-while-error from the L2 memo
(claim never recorded), and fails only a row with neither.
``validate_every`` N runs ``cache_ops.validate_state`` every N waves and
resets (quarantines) any slot whose invariants are broken.

The corpus embeddings the engine inserts stay on the engine's device: a
wave gathers its rows there, never through host memory.

``SessionManager`` is the asynchronous front door: session keys -> engine
slots, turns admitted into continuously scheduled waves, a Future per turn.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import layout, quant
from repro_torch.core.cache import BatchedMetricCache
from repro_torch.core.cache_ops import (CacheConfig, CacheState,
                                        insert_query_batched, probe_batched,
                                        query_batched, validate_state)
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.serve.engine import EngineTurn, radius_from_scores
from repro_torch.serve.router import ShardedRouter
from repro_torch.serve.scheduler import ContinuousScheduler
from repro_torch.serve.telemetry import (SPANS, ServeTelemetry, TurnSpans,
                                         sync_site)

__all__ = ["BatchedEngine", "SessionManager", "WaveState"]

# a wave's spans (each wave numbered by SPANS.new_id; see serve.telemetry)
_PROBE_WAVE = SPANS.kind("serve.probe_wave")
_ENCODE = SPANS.kind("serve.encode")
_PROBE = SPANS.kind("serve.probe")
_BACKEND_WAVE = SPANS.kind("serve.backend_wave")
_PUT_DOCS = SPANS.kind("serve.put_docs")
_FILL_WAVE = SPANS.kind("serve.fill_wave")
_INSERT_QUERY = SPANS.kind("serve.insert_query")
_SCATTER = SPANS.kind("serve.scatter")
_RESOLVE = SPANS.kind("serve.resolve")
_OPEN = SPANS.kind("serve.open")
# every place where the wave's host waits for the device
_QUERIES = sync_site("queries")
_GATHER_IDX = sync_site("gather_idx")
_PROBE_N_QUERIES = sync_site("probe_n_queries")
_PROBE_HIT = sync_site("probe_hit")
_PROBE_PSI = sync_site("probe_psi")
_L2_HIT = sync_site("l2_hit")
_L2_IDS = sync_site("l2_ids")
_DOC_RUNS = sync_site("doc_runs")
_PUT_IDS = sync_site("put_ids")
_PUT_ROWS = sync_site("put_rows")
_OUTAGE_N_DOCS = sync_site("outage_n_docs")
_FILL_RADIUS = sync_site("fill_radius")
_FILL_NEW_IDS = sync_site("fill_new_ids")
_FILL_DO = sync_site("fill_do")
_FILL_RECORD = sync_site("fill_record")
_FILL_DROPPED = sync_site("fill_dropped")
_SCATTER_ROWS = sync_site("scatter_rows")
_FILL_IDS = sync_site("fill_ids")
_FILL_SCORES = sync_site("fill_scores")


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
    idx: torch.Tensor                # pad_sids on the device (int64)
    wave: int
    bucket: int
    psi: torch.Tensor                # (bucket, dim) transformed queries
    psi_np: np.ndarray
    sub: CacheState                  # the wave's gathered rows; doc_emb
                                     # is the stacked payload
    rows: torch.Tensor               # (bucket,) int32 payload row per row
    need: np.ndarray                 # (bucket,) rows still needing backend
    tier: np.ndarray                 # (bucket,) serving tier per row
    reuse: np.ndarray                # (bucket,) L2 memo reuse rows
    l2hit: np.ndarray                # (bucket,) L2 shard-probe hit rows
    new_ids: np.ndarray              # (bucket, k_c + prefetch_width)
    new_emb: torch.Tensor            # (bucket, k_c + prefetch_width, corpus
                                     # width) on the device
    rad: np.ndarray                  # (bucket,) claim radii
    rec_np: np.ndarray               # (bucket,) record the (psi, r_a) claim
    backend_ok: np.ndarray           # (bucket,) rows the backend answered
    failed: np.ndarray               # (bucket,) empty-cache outage rows
    stale: np.ndarray                # (bucket,) stale-while-error memo rows
    admitted_at: np.ndarray          # (wave,) perf_counter admission stamps
    t_start: float                   # wave (probe-phase) start stamp
    degraded: bool = False
    shed: bool = False               # back end fenced: load-shed wave
    outage: Optional[BaseException] = None
    probe_s: float = 0.0
    backend_s: float = 0.0
    wave_id: int = -1                # the wave's id in the span log


class BatchedEngine:
    """S concurrent client sessions over one stacked metric cache.

    ``doc_embeddings`` (N, width >= dim) are the transformed corpus rows the
    engine inserts, moved to ``device`` once (None means ``cuda``; a tensor
    already there is used without a copy, so it can share storage with the
    shard's corpus).  ``dtype`` is the cache storage format (None follows
    ``REPRO_CORPUS_DTYPE``).  ``shared`` (a ``SharedTier`` on the same
    device), ``cluster`` and ``prefetch_width``, and ``validate_every`` as
    in the module docstring.
    """

    def __init__(self, router: ShardedRouter, doc_embeddings, *, dim: int,
                 n_sessions: int, k: int = 10, k_c: int = 1000,
                 epsilon: float = 0.04, capacity: Optional[int] = None,
                 encoder: Optional[Callable] = None,
                 dtype: Optional[str] = None,
                 shared=None, cluster=None, prefetch_width: int = 0,
                 telemetry: Optional[ServeTelemetry] = None,
                 validate_every: int = 0, device=None):
        self.device = resolve_device(device)
        self.router = router
        self.doc_embeddings = torch.as_tensor(doc_embeddings,
                                              device=self.device)
        self.n_sessions = n_sessions
        self.k, self.k_c, self.epsilon = k, k_c, epsilon
        self.encoder = encoder
        self.cluster = cluster
        self.prefetch_width = int(prefetch_width) if cluster is not None \
            else 0
        if cluster is not None and self.prefetch_width > cluster.max_width:
            raise ValueError(
                f"prefetch_width {self.prefetch_width} exceeds the cluster "
                f"index's neighbor tables (max_width {cluster.max_width})")
        self._prefetched: list[set] = [set() for _ in range(n_sessions)]
        self.prefetch_issued = 0       # docs inserted via prefetch
        self.prefetch_warm_hits = 0    # prefetched docs in cache-served turns
        self.insert_traffic_docs = 0   # docs offered to the L1 insert launch
        self.cache = BatchedMetricCache(CacheConfig(
            capacity=capacity or 16 * k_c, dim=dim, epsilon=epsilon,
            store_dtype=quant.resolve_dtype(dtype)), n_sessions, self.device)
        self.shared = shared
        if shared is not None:
            if shared.cfg.dim != dim:
                raise ValueError("shared tier dim mismatch")
            if shared.device != self.cache.device:
                raise ValueError(f"shared tier on {shared.device}, engine "
                                 f"on {self.cache.device}")
        # the shared tier's host structures are touched from the probe and
        # fill phases and the backend phase (a side thread when waves
        # overlap): its sections serialize on this lock
        self._shared_lock = threading.Lock()
        self.telemetry = telemetry if telemetry is not None \
            else ServeTelemetry()
        self.validate_every = int(validate_every)
        self.quarantined = 0
        self._waves = 0
        self.turns: list[list[EngineTurn]] = [[] for _ in range(n_sessions)]
        # admission identity (slot, generation): bumped by start_session so
        # a recycled slot never inherits its predecessor's votes
        self._gen = np.zeros((n_sessions,), np.int64)

    def start_session(self, session: int):
        """Empty ``session``'s slot for a new conversation.  The cache row is
        reset in place from the host slot alone (no sync, no allocation), on
        the current stream, which orders it before the slot's first wave:
        ``submit`` follows ``open`` on the caller's thread."""
        self.cache.reset(int(session))
        self.turns[session] = []
        self._prefetched[session].clear()
        self._gen[session] += 1

    def quarantine_invalid(self) -> np.ndarray:
        """Run ``cache_ops.validate_state`` over the stacked session caches
        and reset every slot whose invariants are broken (its next turn is
        a compulsory miss).  Returns the reset slots."""
        ok, _problems = validate_state(
            self.cache.state, self.cache.cfg,
            n_corpus=int(self.doc_embeddings.shape[0]))
        bad = np.nonzero(~np.asarray(ok))[0]
        if bad.size:
            for s in bad:
                self.cache.reset(int(s))
                self._prefetched[int(s)].clear()
            self.quarantined += int(bad.size)
            self.telemetry.record_fault("quarantined_slots", int(bad.size))
        return bad

    def _token(self, slot) -> tuple:
        """The slot's current admission identity for the shared tier."""
        return (int(slot), int(self._gen[int(slot)]))

    def _bucket(self, n: int) -> int:
        """Wave sizes padded to powers of two (capped at n_sessions), the
        JAX engine's wave shapes."""
        return min(layout.next_pow2(n), self.n_sessions)

    def _put_docs(self, new_emb: torch.Tensor, runs: list) -> None:
        """``new_emb[row, col0:col0 + len(ids)] = doc_embeddings[ids]`` for
        every (row, col0, ids) run: one gather on the device."""
        if not runs:
            return
        rows = np.concatenate([np.full(len(i), r) for r, _, i in runs])
        cols = np.concatenate([np.arange(c, c + len(i)) for _, c, i in runs])
        ids = np.concatenate([i for _, _, i in runs])
        rows, cols, ids = _DOC_RUNS.device(np.stack([rows, cols, ids]),
                                           self.device, torch.int64)
        new_emb[rows, cols] = self.doc_embeddings[ids]

    # ------------------------------------------------------- probe phase
    def probe_wave(self, sessions, queries,
                   admitted_at: Optional[Sequence[float]] = None
                   ) -> WaveState:
        """Phase 1: encoder + L1 probe over the wave's gathered cache rows
        (every leaf but the payload), then the tiered L2 lookups.  Never
        writes L1."""
        wave_id = SPANS.new_id()
        with _PROBE_WAVE.of(wave_id) as tok:
            ws = self._probe(sessions, queries, admitted_at,
                             SPANS.start_s(tok))
            ws.wave_id = wave_id
        ws.probe_s = SPANS.duration_s(tok)
        return ws

    def _probe(self, sessions, queries, admitted_at, t_start) -> WaveState:
        self._waves += 1
        if self.validate_every and self._waves % self.validate_every == 0:
            self.quarantine_invalid()
        sids = np.asarray(sessions, np.int32)
        if np.unique(sids).size != sids.size:
            raise ValueError("one turn per session per wave")
        wave = len(sids)
        bucket = self._bucket(wave)
        admitted = (np.full((wave,), t_start, np.float64)
                    if admitted_at is None
                    else np.asarray(admitted_at, np.float64))
        pad_sids = np.concatenate([sids, np.repeat(sids[:1], bucket - wave)])
        q = _QUERIES.device(np.stack([np.asarray(x) for x in queries]),
                            self.device)
        q = torch.cat([q, q[:1].expand((bucket - wave,) + q.shape[1:])])
        with _ENCODE:
            psi = (self.encoder(q) if self.encoder else q).to(torch.float32)

        with _PROBE:
            idx = _GATHER_IDX.device(self.cache.check(pad_sids), self.device)
            sub = self.cache.gather(idx, payload=False)
            # launch 1: the L1 LowQuality probe over the wave's session rows
            pr = probe_batched(sub, psi, self.epsilon,
                               max_queries=self.cache.cfg.max_queries)
            n_queries = _PROBE_N_QUERIES.host(sub.n_queries)
            need = np.logical_or(n_queries == 0, ~_PROBE_HIT.host(pr.hit))
        need[wave:] = False
        tier = np.where(need, "backend", "l1").astype(object)
        width = self.k_c + self.prefetch_width
        ws = WaveState(
            sids=sids, pad_sids=pad_sids, idx=idx, wave=wave, bucket=bucket,
            psi=psi, psi_np=_PROBE_PSI.host(psi), sub=sub,
            rows=idx.to(torch.int32), need=need, tier=tier,
            reuse=np.zeros((bucket,), bool), l2hit=np.zeros((bucket,), bool),
            new_ids=np.full((bucket, width), -1, np.int64),
            new_emb=torch.zeros((bucket, width,
                                 self.doc_embeddings.shape[1]),
                                dtype=self.doc_embeddings.dtype,
                                device=self.device),
            rad=np.zeros((bucket,), np.float32),
            rec_np=np.zeros((bucket,), bool),
            backend_ok=np.zeros((bucket,), bool),
            failed=np.zeros((bucket,), bool),
            stale=np.zeros((bucket,), bool),
            admitted_at=admitted, t_start=t_start)
        if self.shared is not None:
            with self._shared_lock:
                self.shared.tick()
                if need.any():
                    ws.need = self._probe_shared(ws)
            ws.tier[ws.reuse] = "l2_reuse"
            ws.tier[ws.l2hit] = "l2"
        return ws

    def _probe_shared(self, ws: WaveState) -> np.ndarray:
        """Tiered lookups for the L1 misses (the caller holds the shared
        lock).  Returns the residual miss mask after memo reuse and L2
        hits."""
        l2 = self.shared
        runs: list = []
        # L2a — the result memo (host, no launch): a near-duplicate of
        # ANOTHER session's query reuses its k_c result set and records
        # the triangle-corrected claim when it still clears epsilon
        for i in np.nonzero(ws.need)[0]:
            m = l2.memo_lookup(self._token(ws.pad_sids[i]), ws.psi_np[i])
            if m is None:
                continue
            m_ids, _m_scores, claim = m
            ws.reuse[i] = True
            n = min(self.k_c, m_ids.shape[0])
            ws.new_ids[i, :n] = m_ids[:n]
            runs.append((i, 0, np.maximum(m_ids[:n], 0)))
            if claim >= self.epsilon:
                ws.rad[i] = claim
                ws.rec_np[i] = True
            # the reusing session is a distinct retriever of these docs
            l2.offer(self._token(ws.pad_sids[i]), ws.psi_np[i], claim,
                     ws.new_emb[i], ws.new_ids[i])
        rem = np.logical_and(ws.need, ~ws.reuse)
        if rem.any():
            # L2b — launch 2: the same probe kernel over the gathered shard
            # rows (the whole bucket; results masked to the residual misses)
            shards = l2.route(ws.psi_np)
            l2pr = l2.probe_rows(ws.psi, shards)
            ws.l2hit[:] = np.logical_and(_L2_HIT.host(l2pr.hit), rem)
            if ws.l2hit.any():
                # covered by a shared claim: the shard's top k (one
                # wave-kernel launch, only when L2 serves someone)
                _s2, _d2, i2, _sl2 = l2.query_rows(ws.psi, shards, self.k)
                i2_np = _L2_IDS.host(i2)
                for i in np.nonzero(ws.l2hit)[0]:
                    row = i2_np[i][i2_np[i] >= 0]
                    n = min(self.k_c, row.shape[0])
                    ws.new_ids[i, :n] = row[:n]
                    runs.append((i, 0, row[:n]))
            rem = np.logical_and(rem, ~ws.l2hit)
        self._put_docs(ws.new_emb, runs)
        return rem

    # ----------------------------------------------------- backend phase
    def backend_wave(self, ws: WaveState) -> WaveState:
        """Phase 2: ``router.search`` over the residual miss subset (the
        kNN launch runs inside the router's shards).  A total back-end
        failure walks the degradation ladder and raises only when every
        real row failed; a fenced back end (every breaker open) load-sheds
        the wave without searching."""
        tok = -1
        try:
            with _BACKEND_WAVE.of(ws.wave_id) as tok:
                return self._backend(ws)
        finally:
            ws.backend_s = SPANS.duration_s(tok)

    def _backend(self, ws: WaveState) -> WaveState:
        need, wave = ws.need, ws.wave
        if need.any():
            if getattr(self.router, "backend_open", False):
                ws.shed = True
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
                ws.new_ids[miss, :self.k_c] = ans.ids
                with _PUT_DOCS:
                    idx = _PUT_IDS.device(np.maximum(ans.ids, 0),
                                          self.device)
                    ws.new_emb[_PUT_ROWS.device(miss, self.device),
                               :self.k_c] = self.doc_embeddings[idx]
                ws.rad[miss] = radii
                # a degraded merge misses shards: keep the docs, skip
                # the (psi, r_a) record so no cache learns a false claim
                ws.rec_np[miss] = not degraded
                ws.backend_ok = need.copy()
                if self.shared is not None and not degraded:
                    # fresh retrievals feed the shared tier: memoized
                    # for reuse, offered toward admission
                    with self._shared_lock:
                        for j, i in enumerate(miss):
                            tok = self._token(ws.pad_sids[i])
                            self.shared.memo_record(
                                tok, ws.psi_np[i], ans.ids[j],
                                ans.scores[j], float(radii[j]))
                            self.shared.offer(
                                tok, ws.psi_np[i], float(radii[j]),
                                ws.new_emb[i], ws.new_ids[i])
            except TimeoutError as e:
                self._outage_fallback(ws, e)
                if ws.failed[:wave].all():
                    raise
        return ws

    def _outage_fallback(self, ws: WaveState, e: BaseException) -> None:
        """The degradation ladder of a shed or failed search: warm-cache
        rows answer from their caches (the fill phase's query path),
        empty-cache rows try the L2 memo stale-while-error (TTL and
        same-session gates waived; the docs warm L1, the claim is never
        recorded), and only rows with neither fail."""
        ws.degraded = True
        ws.outage = e
        failed = np.logical_and(ws.need,
                                _OUTAGE_N_DOCS.host(ws.sub.n_docs) == 0)
        if self.shared is not None and failed.any():
            runs: list = []
            with self._shared_lock:
                for i in np.nonzero(failed)[0]:
                    m = self.shared.memo_lookup(
                        self._token(ws.pad_sids[i]), ws.psi_np[i],
                        allow_stale=True)
                    if m is None:
                        continue
                    m_ids, _m_scores, _claim = m
                    ws.reuse[i] = True
                    ws.stale[i] = True
                    ws.tier[i] = "l2_reuse"
                    n = min(self.k_c, m_ids.shape[0])
                    ws.new_ids[i, :n] = m_ids[:n]
                    runs.append((i, 0, np.maximum(m_ids[:n], 0)))
                    failed[i] = False        # rec_np stays False: no claim
                    self.telemetry.record_fault("stale_served")
            self._put_docs(ws.new_emb, runs)
        ws.failed = failed

    # -------------------------------------------------------- fill phase
    def fill_wave(self, ws: WaveState) -> list:
        """Phase 3: the cluster prefetch, the fused insert+query launch (or
        the query launch of a wave with nothing to insert) on the stacked
        payload, the scatter back of the small leaves, the admission flush,
        and one ``EngineTurn`` per real session in input order (a
        ``TimeoutError`` for a failed one)."""
        with _FILL_WAVE.of(ws.wave_id) as tok:
            return self._fill(ws, SPANS.start_s(tok))

    def _fill(self, ws: WaveState, t0: float) -> list:
        if self.prefetch_width:
            # widen each fresh back-end answer by its cluster's nearest
            # documents (the extra buffer columns, the same fused launch);
            # ball(c, d_w) cached whole makes ball(psi, d_w - ||psi - c||)
            # cached too, so the claim widens to max(r_a, that bound)
            runs: list = []
            for i in np.nonzero(ws.backend_ok)[0]:
                extra, bound = self.cluster.prefetch(
                    ws.psi_np[i], ws.new_ids[i, :self.k_c],
                    self.prefetch_width)
                if extra.size:
                    ws.new_ids[i, self.k_c:self.k_c + extra.size] = extra
                    runs.append((i, self.k_c, extra))
                    self.prefetch_issued += int(extra.size)
                    self._prefetched[int(ws.pad_sids[i])].update(
                        extra.tolist())
                if ws.rec_np[i] and bound > ws.rad[i]:
                    ws.rad[i] = bound
            self._put_docs(ws.new_emb, runs)
        fill = ws.reuse | ws.l2hit | ws.backend_ok
        dev = self.device
        with _INSERT_QUERY:
            if fill.any():
                self.insert_traffic_docs += int((ws.new_ids[fill] >= 0).sum())
                # the last launch of the wave: insert + answer query, fused
                (scores, _dists, ids, _slots), sub, dropped = \
                    insert_query_batched(
                        ws.sub, self.cache.cfg, ws.psi,
                        _FILL_RADIUS.device(ws.rad, dev), ws.new_emb,
                        _FILL_NEW_IDS.device(ws.new_ids, dev), self.k,
                        do=_FILL_DO.device(fill, dev),
                        record=_FILL_RECORD.device(ws.rec_np, dev),
                        rows=ws.rows)
                self.cache.total_dropped += int(
                    _FILL_DROPPED.host(dropped.sum()))
            else:   # missless (or outage) wave: probe -> query
                (scores, _dists, ids, _slots), sub = query_batched(
                    ws.sub, ws.psi, self.k, rows=ws.rows)
        with _SCATTER:
            # write back only real, answerable rows (padded rows shadow
            # row 0)
            able = _SCATTER_ROWS.device(
                np.nonzero(~ws.failed[:ws.wave])[0], dev)
            self.cache.scatter(ws.idx[able], sub, rows=able)
        if self.shared is not None:
            # end of wave: promote the admitted answers into their shards
            with self._shared_lock:
                self.shared.flush_admissions()
        ids_np, scores_np = _FILL_IDS.host(ids), _FILL_SCORES.host(scores)

        with _RESOLVE as tok:
            resolved = SPANS.start_s(tok)
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
                row_ids = ids_np[i][real]
                row_tier = str(ws.tier[i])
                pre = self._prefetched[int(s)]
                n_pre = (sum(1 for d in row_ids.tolist() if d in pre)
                         if pre else 0)
                if n_pre and row_tier != "backend":
                    self.prefetch_warm_hits += n_pre
                spans = TurnSpans(
                    queue_wait_s=max(
                        ws.t_start - float(ws.admitted_at[i]), 0.0),
                    probe_s=ws.probe_s, backend_s=ws.backend_s,
                    insert_s=insert_s,
                    total_s=resolved - float(ws.admitted_at[i]),
                    tier=row_tier)
                # a degraded wave degrades its backend rows and any row
                # served stale-while-error (fresh tier hits stay
                # first-class)
                turn = EngineTurn(ids=row_ids, scores=scores_np[i][real],
                                  hit=row_tier != "backend",
                                  degraded=bool(ws.degraded
                                                and (row_tier == "backend"
                                                     or ws.stale[i])),
                                  latency_s=spans.total_s, tier=row_tier,
                                  queue_wait_s=spans.queue_wait_s,
                                  spans=spans, prefetch_hits=n_pre)
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
        """Turns served per tier (``l1`` / ``l2`` / ``l2_reuse`` /
        ``backend``), each session's first turn excluded by default."""
        counts = {"l1": 0, "l2": 0, "l2_reuse": 0, "backend": 0}
        for turns in self.turns:
            for t in (turns[1:] if skip_first else turns):
                counts[t.tier] += 1
        return counts

    def prefetch_stats(self) -> dict:
        """Cluster-prefetch accounting: docs ``issued`` by prefetch, their
        ``warm_hits`` in cache-served turns, the ``insert_traffic_docs``
        offered to the L1 insert launch, and the ``width``."""
        return {"issued": self.prefetch_issued,
                "warm_hits": self.prefetch_warm_hits,
                "insert_traffic_docs": self.insert_traffic_docs,
                "width": self.prefetch_width}


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
        with _OPEN:
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
