"""Deterministic fault injection for the serving stack.

A copy of ``repro.serve.faults`` (numpy and threading only), kept in the
port so that it imports nothing of the JAX package.  One fault model for
the tests and ``chip_smoke.py``'s chaos replay:

  * ``FaultSpec`` — one fault behavior on a *call-count* schedule: the
    spec is active for calls in ``[start, stop)`` whose phase within
    ``period`` falls inside ``width``.  ``period=1`` makes a solid
    outage window; ``width < period`` makes a flapping or every-Nth
    pattern.  Schedules key on the wrapped shard's own call counter, so
    a run is bit-reproducible regardless of wall clock or thread timing.
  * ``FaultyShard`` — wraps one shard callable ``(queries, k) ->
    ShardAnswer`` (a ``repro_torch.dist.retrieval.DeviceShard``, say) and
    applies its specs per call: latency spikes (``latency``; a spike past
    the router deadline IS a timeout), raised exceptions / flapping
    outages (``error``), and *corrupt* answers (``corrupt``): NaN or +inf
    scores, out-of-range ids, or wrong shapes — the poison the router's
    answer validation must stop before ``_merge`` ranks on it.
  * ``FaultPlan`` — a seeded schedule over a whole shard set;
    ``plan.wrap(shards)`` returns the faulty fleet (every shard is
    wrapped, spec-less ones as transparent call counters).
  * ``chaos_plan`` — the committed chaos schedule: shard 0 flaps (two
    outage windows, so its breaker must open, half-open probe, re-close,
    and re-open), shard 1 spikes latency, shard 2 returns corrupt answers
    rotating through every corruption mode, remaining shards stay healthy
    (so availability is answerable throughout).

Corruption payloads derive from ``numpy.random.default_rng((seed,
call))`` — deterministic per (plan seed, call index), independent of
call interleaving across shards.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Mapping, Optional, Sequence

import numpy as np

from repro_torch.serve.router import ShardAnswer

__all__ = ["FaultError", "FaultSpec", "FaultyShard", "FaultPlan",
           "chaos_plan", "CORRUPT_MODES"]

CORRUPT_MODES = ("nan", "inf", "oob", "shape")


class FaultError(RuntimeError):
    """The exception an injected ``error`` fault raises."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault behavior on a deterministic call-count schedule.

    Active for call index ``c`` iff ``start <= c`` (``< stop`` when
    ``stop`` is set) and ``(c - start) % period < width``.
    """

    kind: str                    # "latency" | "error" | "corrupt"
    start: int = 0               # first affected call index
    stop: Optional[int] = None   # half-open end of the window (None: ever)
    period: int = 1              # schedule cycle inside the window
    width: int = 1               # active calls per cycle (flap duty)
    delay_s: float = 0.0         # latency kind: injected sleep
    mode: str = "nan"            # corrupt kind: CORRUPT_MODES or "mix"

    def __post_init__(self):
        if self.kind not in ("latency", "error", "corrupt"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.period < 1 or not (1 <= self.width <= self.period):
            raise ValueError("need period >= 1 and 1 <= width <= period")
        if self.kind == "corrupt" and self.mode not in \
                CORRUPT_MODES + ("mix",):
            raise ValueError(f"unknown corrupt mode {self.mode!r}")

    def active(self, call: int) -> bool:
        """Whether this spec fires on the given call index."""
        if call < self.start:
            return False
        if self.stop is not None and call >= self.stop:
            return False
        return (call - self.start) % self.period < self.width


def _corrupt(ans: ShardAnswer, mode: str, seed: int, call: int
             ) -> ShardAnswer:
    """Poison a well-formed answer the way a broken shard would."""
    rng = np.random.default_rng((seed, call))
    if mode == "mix":
        mode = CORRUPT_MODES[call % len(CORRUPT_MODES)]
    scores = np.array(ans.scores, np.float32, copy=True)
    # widened: a DeviceShard answers int32 ids, which cannot hold "oob"
    ids = np.array(ans.ids, np.int64, copy=True)
    if mode == "nan":
        cols = rng.integers(0, scores.shape[1], max(1, scores.shape[1] // 4))
        scores[:, cols] = np.nan
    elif mode == "inf":
        scores[:, 0] = np.inf
    elif mode == "oob":
        # ids far outside any corpus (and one below the -1 sentinel)
        ids[:, 0] = 2 ** 40
        if ids.shape[1] > 1:
            ids[:, 1] = -7
    elif mode == "shape":
        # transposed result: (k, B) where (B, k) is owed
        scores, ids = scores.T, ids.T
    return ShardAnswer(scores, ids)


class FaultyShard:
    """One shard callable wrapped with a deterministic fault schedule.

    Thread-safe: concurrent calls (hedges, retries) each draw a distinct
    call index.  A spec-less wrapper is a transparent pass-through that
    still counts calls — useful for asserting a shard was (not) called.
    """

    def __init__(self, inner: Callable, specs: Sequence[FaultSpec] = (),
                 *, seed: int = 0):
        self.inner = inner
        self.specs = tuple(specs)
        self.seed = seed
        self.calls = 0
        self.faults = 0              # calls on which any spec fired
        self._lock = threading.Lock()

    def __call__(self, queries, k):
        with self._lock:
            call = self.calls
            self.calls += 1
        active = [s for s in self.specs if s.active(call)]
        if active:
            with self._lock:
                self.faults += 1
        for s in active:             # latency composes with the others
            if s.kind == "latency":
                time.sleep(s.delay_s)
        for s in active:
            if s.kind == "error":
                raise FaultError(
                    f"injected outage (call {call}, spec {s.kind})")
        ans = self.inner(queries, k)
        for s in active:
            if s.kind == "corrupt":
                ans = _corrupt(ans, s.mode, self.seed, call)
        return ans


class FaultPlan:
    """A seeded fault schedule over a whole shard fleet.

    ``specs``: mapping shard index -> sequence of ``FaultSpec``.  The
    plan is data; ``wrap(shards)`` instantiates it over concrete shard
    callables (every shard wrapped, so per-shard call counts are always
    observable via ``plan.wrapped``).
    """

    def __init__(self, specs: Mapping[int, Sequence[FaultSpec]],
                 seed: int = 0):
        self.specs = {int(i): tuple(v) for i, v in specs.items()}
        self.seed = seed
        self.wrapped: list[FaultyShard] = []

    def wrap(self, shards: Sequence[Callable]) -> list:
        """Wrap the fleet; returns the faulty shard callables."""
        self.wrapped = [
            FaultyShard(s, self.specs.get(i, ()), seed=self.seed + i)
            for i, s in enumerate(shards)]
        return list(self.wrapped)

    def calls(self) -> list:
        """Per-shard call counts of the last wrapped fleet."""
        return [w.calls for w in self.wrapped]


def chaos_plan(n_shards: int, *, seed: int = 0, spike_s: float = 0.05,
               flap_down: int = 6, flap_up: int = 8) -> FaultPlan:
    """The committed chaos schedule the CI gate replays.

    * shard 0 — flapping outage: healthy warm-up (4 calls), then two
      ``flap_down``-call outage windows separated by ``flap_up`` healthy
      calls; its breaker must open, probe, re-close, and survive the
      second window.
    * shard 1 — latency spikes: every 3rd call sleeps ``spike_s`` (size
      it against the router deadline to exercise hedging or timeouts).
    * shard 2 — corrupt answers: every other call in a long window,
      rotating through every corruption mode (NaN, +inf, out-of-range
      ids, transposed shapes) so each validation path is exercised.
    * shards 3+ — healthy: the degraded merges stay answerable, keeping
      warm-session availability at the >= 0.99 gate.
    """
    if n_shards < 3:
        raise ValueError("chaos_plan needs >= 3 shards "
                         "(flapping / spiking / corrupt)")
    w0 = 4 + flap_down          # end of shard 0's first outage window
    return FaultPlan({
        0: (FaultSpec("error", start=4, stop=w0),
            FaultSpec("error", start=w0 + flap_up,
                      stop=w0 + flap_up + flap_down)),
        1: (FaultSpec("latency", start=2, period=3, delay_s=spike_s),),
        2: (FaultSpec("corrupt", start=2, stop=60, period=2, mode="mix"),),
    }, seed=seed)
