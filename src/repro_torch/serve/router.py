"""Serving router: straggler mitigation, circuit breakers, degraded answers.

The back-end index is a set of shard handles (callables).  Production
posture for thousands of nodes:

  * **Batched scatter-gather**: concurrent session queries arrive as one
    stacked ``search`` (the paper batches 216 queries into FAISS for the
    same reason); admission batching itself lives in
    ``repro_torch.serve.scheduler``.
  * **Hedging / straggler mitigation**: each shard call runs with a
    deadline; shards that miss it are retried once (hedge), and if the
    retry also misses, the router returns a *degraded* answer assembled
    from the shards that did respond — the merge of per-shard top-k is
    correct on the surviving subset.
  * **Circuit breakers**: each shard carries a closed / open / half-open
    ``CircuitBreaker`` over a sliding failure-rate window.  An open
    shard is skipped *immediately* (no submit, no deadline wait) and the
    merge marked degraded; after ``breaker_cooldown_s`` the breaker goes
    half-open and admits exactly one probe call — success re-closes it,
    failure re-opens.  A flapping shard therefore costs one probe per
    cooldown instead of a deadline per search.  When EVERY breaker is
    open the router is ``backend_open`` and ``search`` fails fast (the
    engine load-sheds the wave instead of waiting out the deadline).
  * **Bounded retry**: a failed or rejected shard call is retried up to
    ``max_retries`` times with exponential backoff and deterministic
    jitter, always inside the remaining deadline budget.
  * **Answer validation**: a shard answer is checked (shape, dtype,
    finite scores, id bounds) *before* it can reach ``_merge`` — a NaN
    score column would otherwise silently corrupt the ``argsort`` rank
    order.  Rejected answers count as shard failures.
  * **Cache as fault tolerance**: when the client holds a CACHE, a degraded
    or failed back-end turn can still be answered from cached embeddings —
    the paper's mechanism doubles as a resilience layer (tested).

This module is deliberately execution-agnostic (thread pool here; the same
logic fronts RPC stubs on a real cluster).  It is a copy of
``repro.serve.router`` (numpy and threading only), kept in the port so the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.serve.telemetry import SPANS

__all__ = ["ShardAnswer", "RouterStats", "CircuitBreaker", "ShardedRouter",
           "AnswerValidationError", "validate_answer"]


@dataclasses.dataclass
class ShardAnswer:
    scores: np.ndarray     # (B, k)
    ids: np.ndarray        # (B, k)


class AnswerValidationError(ValueError):
    """A shard answer failed validation (malformed, NaN, out-of-range)."""


def validate_answer(ans, n_queries: int, k: int,
                    n_docs: Optional[int] = None) -> None:
    """Reject a malformed shard answer before it can poison ``_merge``.

    Checks: ``scores``/``ids`` are 2-D with matching shapes, one row per
    query and at most ``k`` columns (short answers from tiny shards are
    legal — the merge sentinel-pads them); ``ids`` are integral, ``>= -1``
    and (when the corpus size is known) ``< n_docs``; ``scores`` carry no
    NaN and no ``+inf``, and ``-inf`` only on ``id == -1`` sentinel slots.
    Raises ``AnswerValidationError``; never mutates the answer.
    """
    scores = getattr(ans, "scores", None)
    ids = getattr(ans, "ids", None)
    if scores is None or ids is None:
        raise AnswerValidationError("answer missing scores/ids")
    scores, ids = np.asarray(scores), np.asarray(ids)
    if scores.ndim != 2 or scores.shape != ids.shape:
        raise AnswerValidationError(
            f"bad answer shape: scores {scores.shape} ids {ids.shape}")
    if scores.shape[0] != n_queries or not (1 <= scores.shape[1] <= k):
        raise AnswerValidationError(
            f"answer shape {scores.shape} vs ({n_queries}, <= {k}) owed")
    if not np.issubdtype(ids.dtype, np.integer):
        raise AnswerValidationError(f"non-integral ids ({ids.dtype})")
    if (ids < -1).any() or (n_docs is not None and (ids >= n_docs).any()):
        raise AnswerValidationError("doc ids out of range")
    if np.isnan(scores).any() or (scores == np.inf).any():
        raise AnswerValidationError("non-finite scores (NaN/+inf)")
    if np.logical_and(np.isneginf(scores), ids != -1).any():
        raise AnswerValidationError("-inf score on a non-sentinel id")


@dataclasses.dataclass
class RouterStats:
    """Router health counters.  All mutation goes through ``bump`` /
    ``shard_bump`` under one lock — concurrent ``search`` calls (the
    scheduler overlaps backend waves) would otherwise lose ``+=``
    updates.  ``per_shard`` holds one counter dict per shard:
    ``calls`` / ``failures`` / ``rejected`` / ``timeouts`` / ``retries``
    / ``breaker_skips``."""

    calls: int = 0
    hedges: int = 0
    failures: int = 0
    degraded: int = 0
    duplicates: int = 0    # hedge losers whose answers were discarded
    retries: int = 0       # backoff re-attempts inside one shard call
    rejected: int = 0      # shard answers refused by validation
    timeouts: int = 0      # shard calls written off at the deadline
    breaker_skips: int = 0  # shard calls skipped: breaker open
    breaker_opens: int = 0
    breaker_closes: int = 0
    shed: int = 0          # whole searches refused: every breaker open
    per_shard: list = dataclasses.field(default_factory=list)
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    def bump(self, name: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + n)

    def shard_bump(self, shard: int, name: str, n: int = 1) -> None:
        with self._lock:
            self.per_shard[shard][name] += n


class CircuitBreaker:
    """Per-shard closed -> open -> half-open breaker.

    Failure accounting is a sliding window of the last ``window`` call
    outcomes; once at least ``min_calls`` outcomes are in the window and
    the failure fraction reaches ``fail_rate``, the breaker OPENS:
    ``allow()`` refuses calls until ``cooldown_s`` has elapsed, then the
    breaker goes HALF-OPEN and admits exactly one probe call — a
    successful probe resets the window and re-closes, a failed one
    re-opens and re-arms the cooldown.  ``clock`` is injectable for
    deterministic tests; ``on_transition(old, new)`` (kept cheap — it
    runs under the breaker lock) feeds stats/telemetry.
    """

    def __init__(self, window: int = 16, fail_rate: float = 0.5,
                 min_calls: int = 4, cooldown_s: float = 0.5,
                 clock: Callable[[], float] = time.monotonic,
                 on_transition: Optional[Callable] = None):
        if not (0.0 < fail_rate <= 1.0):
            raise ValueError("fail_rate must be in (0, 1]")
        self.window, self.fail_rate = window, fail_rate
        self.min_calls, self.cooldown_s = min_calls, cooldown_s
        self.on_transition = on_transition
        self._clock = clock
        self._lock = threading.Lock()
        self._outcomes: list[bool] = []
        self._opened_at = 0.0
        self._probe_out = False
        self.state = "closed"
        self.opens = 0
        self.closes = 0

    def _transition(self, new: str) -> None:
        old, self.state = self.state, new
        if new == "open":
            self.opens += 1
            self._opened_at = self._clock()
            self._outcomes.clear()
        elif new == "closed":
            self.closes += 1
            self._outcomes.clear()
        if self.on_transition is not None:
            self.on_transition(old, new)

    def allow(self) -> bool:
        """May a call go out now?  (Mutates: grants the half-open probe.)"""
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                if self._clock() - self._opened_at < self.cooldown_s:
                    return False
                self._transition("half_open")
                self._probe_out = True
                return True
            if self._probe_out:     # half-open: one probe in flight
                return False
            self._probe_out = True
            return True

    def peek(self) -> bool:
        """Non-mutating: would ``allow()`` grant a call right now?"""
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                return self._clock() - self._opened_at >= self.cooldown_s
            return not self._probe_out

    def record(self, ok: bool) -> None:
        """Fold one call outcome in (success, failure, or timeout)."""
        with self._lock:
            if self.state == "half_open":
                self._probe_out = False
                self._transition("closed" if ok else "open")
                return
            if self.state == "open":
                return              # late result of a pre-open call
            self._outcomes.append(bool(ok))
            if len(self._outcomes) > self.window:
                del self._outcomes[0]
            n = len(self._outcomes)
            if n >= self.min_calls and \
                    (n - sum(self._outcomes)) / n >= self.fail_rate:
                self._transition("open")


_SEARCH = SPANS.kind("serve.search")
_MERGE = SPANS.kind("serve.merge")


def _discard(future: cf.Future) -> bool:
    """Drop a future we no longer want: cancel if not started, otherwise
    attach a consumer so its result/exception is drained, never merged.
    Returns True when the future was already running (a real duplicate
    in flight), False when it was cancelled before ever starting."""
    if future.cancel():
        return False
    future.add_done_callback(lambda f: f.exception())
    return True


def _jitter(shard: int, call: int, attempt: int) -> float:
    """Deterministic backoff jitter in [0, 1): hashed from the call
    coordinates, so retry timing is reproducible without shared RNG
    state across router threads."""
    h = (shard * 2654435761 + call * 40503 + attempt * 69069) & 0xFFFFFFFF
    return (h % 1000) / 1000.0


class ShardedRouter:
    """shards: callables (queries, k) -> ShardAnswer, one per corpus shard.

    Shards may be plain host callables (RPC stubs, test lambdas) or
    device-resident handles — ``over_devices`` builds a router fronting
    ``repro_torch.dist.retrieval.DeviceShard``s, one corpus slice per device.

    Owns a thread pool: ``close()`` it (or use the router as a context
    manager) so worker threads don't leak across benchmark runs/tests.
    """

    def __init__(self, shards: Sequence[Callable], deadline_s: float = 1.0,
                 hedge_after_s: Optional[float] = None, max_workers: int = 16,
                 max_retries: int = 1, backoff_base_s: float = 0.01,
                 n_docs: Optional[int] = None,
                 breaker_window: int = 16, breaker_fail_rate: float = 0.5,
                 breaker_min_calls: int = 4, breaker_cooldown_s: float = 0.5,
                 telemetry=None):
        self.shards = list(shards)
        self.deadline_s = deadline_s
        self.hedge_after_s = hedge_after_s or deadline_s / 2
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        self.n_docs = n_docs
        self.telemetry = telemetry
        self.pool = cf.ThreadPoolExecutor(max_workers=max_workers)
        self.stats = RouterStats(per_shard=[
            {"calls": 0, "failures": 0, "rejected": 0, "timeouts": 0,
             "retries": 0, "breaker_skips": 0}
            for _ in self.shards])
        self.breakers = [
            CircuitBreaker(window=breaker_window,
                           fail_rate=breaker_fail_rate,
                           min_calls=breaker_min_calls,
                           cooldown_s=breaker_cooldown_s,
                           on_transition=self._transition_cb(i))
            for i in range(len(self.shards))]

    @classmethod
    def over_devices(cls, docs, doc_ids=None, *, devices=None,
                     **kwargs) -> "ShardedRouter":
        """Router fronting device-sharded corpus slices (one per device)."""
        from repro_torch.dist.retrieval import make_device_shards
        return cls(make_device_shards(docs, doc_ids, devices=devices),
                   **kwargs)

    # --------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Shut the scatter-gather pool down (idempotent).  In-flight
        calls are cancelled where possible; further ``search``es raise."""
        self.pool.shutdown(wait=False, cancel_futures=True)

    def __enter__(self) -> "ShardedRouter":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False

    # ------------------------------------------------------------ health
    def _transition_cb(self, shard: int) -> Callable:
        def cb(old: str, new: str) -> None:
            if new == "open":
                self.stats.bump("breaker_opens")
            elif new == "closed":
                self.stats.bump("breaker_closes")
            if self.telemetry is not None:
                self.telemetry.record_breaker(shard, old, new)
        return cb

    @property
    def backend_open(self) -> bool:
        """True when no shard would currently accept a call — the whole
        back end is fenced off and callers should load-shed instead of
        paying the deadline."""
        return not any(b.peek() for b in self.breakers)

    def shard_health(self) -> list:
        """Per-shard snapshot: breaker state + lifetime counters."""
        with self.stats._lock:
            counters = [dict(d) for d in self.stats.per_shard]
        return [{"state": b.state, "opens": b.opens, "closes": b.closes,
                 **c} for b, c in zip(self.breakers, counters)]

    # ------------------------------------------------------------ search
    def _call(self, i: int, queries: np.ndarray, k: int, call_id: int,
              deadline: float, span: int = -1) -> ShardAnswer:
        """One shard call with validation + bounded backoff retry, run on
        a pool thread for the search span ``span`` (its spans are that
        span's children, in its wave).  Records every attempt's outcome
        into the shard's breaker; raises only once the retry budget (or
        the remaining deadline) is exhausted."""
        SPANS.adopt(span)
        try:
            return self._attempts(i, queries, k, call_id, deadline)
        finally:
            SPANS.adopt(-1)

    def _attempts(self, i: int, queries: np.ndarray, k: int, call_id: int,
                  deadline: float) -> ShardAnswer:
        attempt = 0
        while True:
            try:
                ans = self.shards[i](queries, k)
                validate_answer(ans, len(queries), k, self.n_docs)
                self.breakers[i].record(True)
                self.stats.shard_bump(i, "calls")
                return ans
            except AnswerValidationError:
                self.breakers[i].record(False)
                self.stats.bump("rejected")
                self.stats.shard_bump(i, "rejected")
                self.stats.shard_bump(i, "calls")
                if self.telemetry is not None:
                    self.telemetry.record_fault("rejected_answers")
            except Exception:
                self.breakers[i].record(False)
                self.stats.shard_bump(i, "failures")
                self.stats.shard_bump(i, "calls")
            attempt += 1
            delay = self.backoff_base_s * (2.0 ** (attempt - 1))
            delay *= 1.0 + _jitter(i, call_id, attempt)
            if attempt > self.max_retries or \
                    time.monotonic() + delay >= deadline:
                raise TimeoutError(f"shard {i} failed (attempt {attempt})")
            self.stats.bump("retries")
            self.stats.shard_bump(i, "retries")
            time.sleep(delay)

    def search(self, queries: np.ndarray, k: int) -> tuple[ShardAnswer, bool]:
        """Scatter-gather with breakers + hedging.  Returns (merged
        answer, degraded?).

        Open-breaker shards are skipped up front (their absence alone
        marks the merge degraded); a half-open shard gets its single
        probe call.  The gather loop wakes on completions, the hedge
        point, or the deadline — never a fixed busy-poll.  A hedged
        retry and its original can both complete; the first answer per
        shard wins and every sibling in flight for that shard is
        explicitly discarded (``cancel()`` alone is a no-op once a
        future is running), so a shard's answer is merged at most once
        and the loop never stalls waiting on a hedge loser.
        """
        with _SEARCH as span:
            return self._search(queries, k, span)

    def _search(self, queries: np.ndarray, k: int,
                span: int) -> tuple[ShardAnswer, bool]:
        self.stats.bump("calls")
        call_id = self.stats.calls
        answers: dict[int, ShardAnswer] = {}
        deadline = time.monotonic() + self.deadline_s
        hedge_at = time.monotonic() + self.hedge_after_s
        hedged: set[int] = set()
        pending: dict[cf.Future, int] = {}
        for i, _ in enumerate(self.shards):
            if self.breakers[i].allow():
                pending[self.pool.submit(
                    self._call, i, queries, k, call_id, deadline,
                    span)] = i
            else:
                self.stats.bump("breaker_skips")
                self.stats.shard_bump(i, "breaker_skips")
        if not pending:
            self.stats.bump("shed")
            self.stats.bump("degraded")
            raise TimeoutError(
                "back end fenced: every shard's circuit breaker is open")
        while pending and (now := time.monotonic()) < deadline:
            # wake on a completion, the hedge point, or the deadline —
            # whichever is first (no fixed-interval busy-poll)
            wait_s = max(min(hedge_at, deadline) - now, 0.0)
            done, _ = cf.wait(list(pending), timeout=wait_s,
                              return_when=cf.FIRST_COMPLETED)
            for f in done:
                i = pending.pop(f, None)
                if i is None:          # sibling already discarded below
                    continue
                try:
                    result = f.result()
                except Exception:
                    self.stats.bump("failures")
                    continue
                answers[i] = result
                # drop the hedge sibling (winner merged, loser drained);
                # only a loser that actually ran counts as duplicate work
                for f2, i2 in list(pending.items()):
                    if i2 == i:
                        del pending[f2]
                        if _discard(f2):
                            self.stats.bump("duplicates")
            # hedge slow shards once (closed breakers only: a half-open
            # shard's single probe must stay single)
            if time.monotonic() >= hedge_at:
                for f, i in list(pending.items()):
                    if i not in hedged and self.breakers[i].state == "closed":
                        hedged.add(i)
                        self.stats.bump("hedges")
                        pending[self.pool.submit(
                            self._call, i, queries, k, call_id, deadline,
                            span)] = i
                hedge_at = float("inf")
        # shards still pending at the deadline are written off as
        # timeouts — the breaker hears about them (a shard that never
        # answers must be able to trip its breaker too)
        for i in set(pending.values()):
            self.stats.bump("timeouts")
            self.stats.shard_bump(i, "timeouts")
            self.breakers[i].record(False)
        for f in pending:
            _discard(f)
        degraded = len(answers) < len(self.shards)
        if degraded:
            self.stats.bump("degraded")
        if not answers:
            raise TimeoutError("all index shards failed or timed out")
        with _MERGE:
            merged = self._merge(list(answers.values()), k)
        return merged, degraded

    @staticmethod
    def _merge(parts: list[ShardAnswer], k: int) -> ShardAnswer:
        """Merge per-shard top-k, always returning exactly ``k`` columns.

        Surviving shards may hold fewer than k candidates in total (tiny
        shards, degraded subsets); short rows are padded with explicit
        sentinels (score -inf, id -1) so consumers can detect them instead
        of misreading the last column as the true k-th neighbour.  Inputs
        are pre-validated (``validate_answer``), so the sort never ranks
        on NaN.
        """
        scores = np.concatenate([p.scores for p in parts], axis=1)
        ids = np.concatenate([p.ids for p in parts], axis=1)
        if scores.shape[1] < k:
            pad = k - scores.shape[1]
            scores = np.pad(scores, ((0, 0), (0, pad)),
                            constant_values=-np.inf)
            ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=-1)
        order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
        return ShardAnswer(np.take_along_axis(scores, order, axis=1),
                           np.take_along_axis(ids, order, axis=1))
