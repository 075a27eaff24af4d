"""Serving telemetry: per-turn latency spans and streaming percentiles.

The paper's case is *latency* — the cache exists so a conversational turn
answers fast — so the serving tier must be able to state a p99 for a
single turn, not just a closed-loop throughput.  This module is the
measurement substrate the continuous scheduler and ``serve_bench``'s
open-loop harness share:

  * ``TurnSpans`` — one turn's latency decomposition: queue wait
    (admission -> wave start), probe (L1/L2 cache launches), backend
    (router round-trip over the miss subset), insert (fused insert+query
    close), and the admission-to-resolution total.  Spans other than
    queue wait are wave-level (every turn of a wave shares them); the
    queue wait and total are strictly per turn.
  * ``RingPercentiles`` — a fixed-capacity ring buffer with nearest-rank
    percentile estimates over the most recent window.  O(1) insertion on
    the serving path; sorting is deferred to ``percentile()``/
    ``summary()`` (telemetry readers, not the hot loop).
  * ``EwmaRate`` — an exponentially weighted arrival-rate estimator whose
    smoothing follows a wall-clock *horizon* (irregular arrival spacing is
    handled by weighting each observation with ``1 - exp(-dt/horizon)``).
    The scheduler sizes wave buckets and active engine slots from it.
  * ``ServeTelemetry`` — the aggregate the engine/scheduler write into:
    one ring per span kind, one ring of totals per serving tier
    (l1 / l2 / l2_reuse / backend), wave-size and wave-service histories,
    and a ``summary()`` that flattens to the p50/p95/p99 columns
    ``BENCH_serve.json`` commits and ``check_regression.py`` gates.

Everything here is plain host-side Python, so recording a span never
touches the device.  A copy of ``repro.serve.telemetry``, kept in the
port so the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Optional

__all__ = ["TurnSpans", "RingPercentiles", "EwmaRate", "ServeTelemetry",
           "TIERS"]

TIERS = ("l1", "l2", "l2_reuse", "backend")


@dataclasses.dataclass
class TurnSpans:
    """One turn's latency decomposition, all in seconds.

    ``total_s`` is admission-to-resolution — the honest per-turn SLO
    number (satellite fix: a wave's turns used to all report the wave's
    wall clock, with queue wait invisible).
    """

    queue_wait_s: float = 0.0
    probe_s: float = 0.0
    backend_s: float = 0.0
    insert_s: float = 0.0
    total_s: float = 0.0
    tier: str = "backend"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class RingPercentiles:
    """Fixed-capacity ring of floats with nearest-rank percentiles.

    The ring keeps the most recent ``capacity`` observations (a serving
    process runs forever; an unbounded list would not).  Percentiles use
    the nearest-rank method on a sorted copy of the valid window —
    deterministic, exact over the window, and only paid when read.
    """

    def __init__(self, capacity: int = 4096):
        if capacity <= 0:
            raise ValueError("RingPercentiles capacity must be positive")
        self.capacity = capacity
        self._buf = [0.0] * capacity
        self._n = 0          # monotone total ever added
        self._lock = threading.Lock()

    def add(self, x: float) -> None:
        with self._lock:
            self._buf[self._n % self.capacity] = float(x)
            self._n += 1

    def __len__(self) -> int:
        return min(self._n, self.capacity)

    @property
    def count(self) -> int:
        """Monotone total of observations ever recorded (window may hold
        fewer)."""
        return self._n

    def _window(self) -> list:
        with self._lock:
            m = min(self._n, self.capacity)
            return self._buf[:m]

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile over the current window (NaN if empty).

        ``p`` in [0, 100].
        """
        xs = sorted(self._window())
        if not xs:
            return float("nan")
        rank = max(1, math.ceil(p / 100.0 * len(xs)))
        return xs[min(rank, len(xs)) - 1]

    def summary(self) -> dict:
        """p50/p95/p99 + mean + count in one sorted pass."""
        xs = sorted(self._window())
        if not xs:
            return {"count": self._n, "mean": float("nan"),
                    "p50": float("nan"), "p95": float("nan"),
                    "p99": float("nan")}

        def at(p):
            rank = max(1, math.ceil(p / 100.0 * len(xs)))
            return xs[min(rank, len(xs)) - 1]

        return {"count": self._n, "mean": sum(xs) / len(xs),
                "p50": at(50), "p95": at(95), "p99": at(99)}


class EwmaRate:
    """Arrival-rate estimator (events/sec) with a wall-clock horizon.

    Each ``observe()`` folds the instantaneous rate ``1/dt`` into the
    estimate with weight ``1 - exp(-dt / horizon_s)`` — the continuous-time
    EWMA, so the effective memory is ``horizon_s`` seconds of traffic no
    matter how bursty the arrival spacing is.  The first observation only
    arms the clock (a single event has no rate).

    ``rate()`` additionally decays the estimate by the silence since the
    last event, so a stream that stops reads as a falling rate instead of
    freezing at its last busy value.
    """

    def __init__(self, horizon_s: float = 1.0,
                 clock=time.monotonic):
        if horizon_s <= 0:
            raise ValueError("EwmaRate horizon must be positive")
        self.horizon_s = horizon_s
        self._clock = clock
        self._rate = 0.0
        self._last: Optional[float] = None
        self._lock = threading.Lock()
        self.count = 0          # observations ever folded in

    def observe(self, t: Optional[float] = None) -> None:
        now = self._clock() if t is None else t
        with self._lock:
            self.count += 1
            if self._last is None:
                self._last = now
                return
            dt = max(now - self._last, 1e-9)
            self._last = now
            w = 1.0 - math.exp(-dt / self.horizon_s)
            self._rate += w * (1.0 / dt - self._rate)

    def rate(self, t: Optional[float] = None) -> float:
        """Current estimate in events/sec, decayed for elapsed silence."""
        now = self._clock() if t is None else t
        with self._lock:
            if self._last is None:
                return 0.0
            silence = max(now - self._last, 0.0)
            return self._rate * math.exp(-silence / self.horizon_s)


class ServeTelemetry:
    """Aggregate serving telemetry: spans, per-tier totals, wave shape.

    Writers: ``BatchedEngine.fill_wave`` records one ``TurnSpans`` per
    resolved turn; ``ContinuousScheduler`` records arrivals (for the EWMA)
    and per-wave (size, service seconds) samples.  Readers: the
    scheduler's sizing policy (``arrivals.rate()``, ``wave_service``),
    ``serve_bench``'s open-loop harness, and operators via ``summary()``.
    """

    SPAN_KEYS = ("queue_wait_s", "probe_s", "backend_s", "insert_s",
                 "total_s")

    def __init__(self, capacity: int = 4096, ewma_horizon_s: float = 1.0):
        self.spans = {k: RingPercentiles(capacity) for k in self.SPAN_KEYS}
        self.tier_total = {t: RingPercentiles(capacity) for t in TIERS}
        self.arrivals = EwmaRate(ewma_horizon_s)
        self.wave_sizes = RingPercentiles(capacity)
        self.wave_service = RingPercentiles(capacity)
        self.turns = 0
        self.waves = 0
        # fault-domain counters (breaker transitions, shed / degraded /
        # rejected-answer / stale-served / quarantined events) — written
        # by the router and engine, read by serve_bench --chaos
        self.faults: dict = {}
        self.breaker_log: list = []      # (shard, old_state, new_state)
        self.breaker_transitions = 0     # monotone (the log is bounded)
        self._fault_lock = threading.Lock()

    # ------------------------------------------------------------ writers
    def record_arrival(self, t: Optional[float] = None) -> None:
        self.arrivals.observe(t)

    def record_fault(self, kind: str, n: int = 1) -> None:
        """Count one fault-domain event (``shed_waves``, ``shed_turns``,
        ``degraded_turns``, ``rejected_answers``, ``stale_served``,
        ``quarantined_slots``, ``failed_turns``, ...)."""
        with self._fault_lock:
            self.faults[kind] = self.faults.get(kind, 0) + n

    def record_breaker(self, shard: int, old: str, new: str) -> None:
        """Log one circuit-breaker transition (bounded log + counters)."""
        with self._fault_lock:
            self.breaker_transitions += 1
            self.faults[f"breaker_{new}"] = \
                self.faults.get(f"breaker_{new}", 0) + 1
            if len(self.breaker_log) < 1024:
                self.breaker_log.append((shard, old, new))

    def record_turn(self, spans: TurnSpans) -> None:
        self.turns += 1
        for k in self.SPAN_KEYS:
            self.spans[k].add(getattr(spans, k))
        ring = self.tier_total.get(spans.tier)
        if ring is not None:
            ring.add(spans.total_s)

    def record_wave(self, size: int, service_s: float) -> None:
        self.waves += 1
        self.wave_sizes.add(float(size))
        self.wave_service.add(service_s)

    # ------------------------------------------------------------ readers
    def summary(self) -> dict:
        """Nested summary: per-span and per-tier p50/p95/p99 (+ wave
        shape).  Latency values stay in seconds; presentation layers
        (serve_bench) convert to ms."""
        with self._fault_lock:
            faults = dict(self.faults)
            transitions = self.breaker_transitions
        return {
            "turns": self.turns,
            "waves": self.waves,
            "arrival_rate_hz": self.arrivals.rate(),
            "spans": {k: r.summary() for k, r in self.spans.items()},
            "tiers": {t: r.summary() for t, r in self.tier_total.items()
                      if len(r)},
            "wave_size": self.wave_sizes.summary(),
            "wave_service_s": self.wave_service.summary(),
            "faults": faults,
            "breaker_transitions": transitions,
        }
