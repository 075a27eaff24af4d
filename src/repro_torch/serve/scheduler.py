"""Continuous batching: the slot-scheduled serving front door.

A copy of ``repro.serve.scheduler`` (plain Python and threading), kept in
the port so the port imports nothing of the JAX package.

``ContinuousScheduler``:

  * **admits continuously** — a dedicated worker forms the next wave from
    whatever is queued the moment the engine can take it (no window timer;
    an optional ``window_s`` hold is the fixed-window baseline);
  * **pipelines waves** — with an engine exposing the split wave contract
    (``probe_wave`` / ``backend_wave`` / ``fill_wave``,
    ``repro_torch.serve.session.BatchedEngine``), the cache probe of wave
    *t+1* runs while wave *t*'s back-end search is in flight on a side
    thread.  All cache-state kernel launches stay on the worker thread, so
    waves are serialized where it matters and per-session results remain
    identical to the sequential engine;
  * **sizes itself from telemetry** — an EWMA of the arrival rate times an
    EWMA of wave service time (x ``headroom``) sets the live wave bucket /
    active-slot limit, clamped to ``[min_wave, max_wave]`` and rounded to
    the engine's power-of-two wave buckets; an optional ``target_p99_s``
    backs the limit off when the measured turn p99 overshoots;
  * **stamps admission** — every ``submit`` carries an admission
    timestamp, so queue wait is part of each turn's measured latency
    (``EngineTurn.latency_s`` is admission-to-resolution);
  * **drains per slot** — ``drain_slot`` executes only the closing
    session's pending turns (bypassing any hold), leaving other sessions'
    queued turns to their own schedule;
  * **records its loop** — each pass of the worker's loop is a
    ``serve.loop`` span of the process's span log, so every second of the
    worker is named; inside it ``serve.await_turns`` (waiting for turns,
    and for the lock, with ``serve.admit`` choosing the wave), the
    engine's phase spans, ``serve.join_backend`` (waiting for the wave's
    search on the back-end thread) and ``serve.deliver`` (resolving the
    wave's futures, whose callbacks run there).  Time in ``serve.loop``
    outside its children is the worker's glue, or its wait for the
    interpreter's lock.
"""

from __future__ import annotations

import concurrent.futures as cf
import math
import threading
import time
from typing import Callable, Optional

from repro_torch.core import layout
from repro_torch.serve.telemetry import SPANS, ServeTelemetry

__all__ = ["ContinuousScheduler"]

_LOOP = SPANS.kind("serve.loop")
_AWAIT_TURNS = SPANS.kind("serve.await_turns")
_ADMIT = SPANS.kind("serve.admit")
_JOIN_BACKEND = SPANS.kind("serve.join_backend")
_DELIVER = SPANS.kind("serve.deliver")


class _Item:
    """One admitted turn: payload + slot + waiter + admission stamp."""

    __slots__ = ("payload", "slot", "future", "admitted_at", "released")

    def __init__(self, payload, slot):
        self.payload = payload
        self.slot = slot
        self.future: cf.Future = cf.Future()
        self.admitted_at = time.perf_counter()
        # released: the item was queued when a wave fired (window mode
        # would have flushed it); it no longer waits on any window hold
        # even if it could not join that wave (same-slot defer)
        self.released = False


class _Inflight:
    """A begun wave: its probe state, waiters, and the back-end future."""

    __slots__ = ("ws", "items", "backend_future", "t_start")

    def __init__(self, ws, items, backend_future, t_start):
        self.ws = ws
        self.items = items
        self.backend_future = backend_future
        self.t_start = t_start


class ContinuousScheduler:
    """Slot-scheduled admission pipeline over a wave engine (or plain fn).

    Two execution modes share the admission queue and sizing policy:

    * **engine mode** (``engine=``): items are ``(slot, query)`` turns.
      Waves take at most one turn per slot (same-slot arrivals defer to
      later waves in admission order) and execute through the engine's
      split wave contract, overlapping wave *t+1*'s probe with wave *t*'s
      back-end search when ``overlap=True``.
    * **fn mode** (``fn=``): items are opaque; each wave is one
      ``fn(items) -> results`` call, one result per item in order (a
      result that is an exception instance fails only its own waiter;
      ``fn`` raising fails the wave).

    ``window_s > 0`` enables the deprecated hold-for-window admission
    serve_bench's fixed-window baseline uses; the continuous default is
    ``window_s = 0``.
    """

    def __init__(self, engine=None, *, fn: Optional[Callable] = None,
                 min_wave: int = 1, max_wave: Optional[int] = None,
                 window_s: float = 0.0, adaptive: Optional[bool] = None,
                 headroom: float = 1.5, ewma_horizon_s: float = 1.0,
                 target_p99_s: Optional[float] = None,
                 overlap: bool = True,
                 telemetry: Optional[ServeTelemetry] = None):
        if (engine is None) == (fn is None):
            raise ValueError("pass exactly one of engine= or fn=")
        self._engine = engine
        self._fn = fn
        if max_wave is None:
            max_wave = engine.n_sessions if engine is not None else 64
        if not (1 <= min_wave <= max_wave):
            raise ValueError(f"need 1 <= min_wave <= max_wave, got "
                             f"[{min_wave}, {max_wave}]")
        self.min_wave, self.max_wave = min_wave, max_wave
        self.window_s = window_s
        self.headroom = headroom
        self.target_p99_s = target_p99_s
        self.adaptive = (engine is not None) if adaptive is None else adaptive
        self.overlap = overlap and engine is not None
        self.telemetry = telemetry if telemetry is not None else (
            getattr(engine, "telemetry", None) or ServeTelemetry(
                ewma_horizon_s=ewma_horizon_s))
        self.wave_limit = max_wave      # cold start: absorb bursts
        self._service_ewma = 0.0
        self._queue: list[_Item] = []
        self._active_slots: set = set()
        self._in_wave = 0               # waves taken but not yet resolved
        self._drain: set = set()
        self._flushes = 0               # flush() calls currently waiting
        self._closed = False
        self._cond = threading.Condition()
        self._backend_pool = (cf.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="sched-backend")
            if self.overlap else None)
        self._worker = threading.Thread(target=self._loop,
                                        name="sched-worker", daemon=True)
        self._worker.start()

    # ------------------------------------------------------------- client
    def submit(self, payload, slot=None) -> cf.Future:
        """Admit one item; returns a Future resolved with its result.

        The admission timestamp is stamped here — queue wait (admission to
        wave start) is part of the turn's measured latency."""
        item = _Item(payload, slot)
        with self._cond:
            if self._closed:
                raise RuntimeError(f"{type(self).__name__} is closed")
            self._queue.append(item)
            self.telemetry.record_arrival()
            self._cond.notify_all()
        return item.future

    def flush(self):
        """Execute everything queued *now*; returns once those waves have
        resolved.  New arrivals during the flush may ride along."""
        with self._cond:
            if not self._queue and not self._in_wave:
                return
            self._flushes += 1
            self._cond.notify_all()
            try:
                while self._queue or self._in_wave:
                    if self._closed and not self._worker.is_alive():
                        break
                    self._cond.wait(timeout=0.05)
            finally:
                self._flushes -= 1

    def drain_slot(self, slot):
        """Execute only ``slot``'s pending turns (bypassing any window
        hold) and return once none remain queued or in flight.  Other
        sessions' queued turns keep waiting on their own schedule — this
        is the per-key drain ``SessionManager.close`` uses instead of a
        global flush."""
        with self._cond:
            self._drain.add(slot)
            self._cond.notify_all()
            try:
                while (slot in self._active_slots
                       or any(it.slot == slot for it in self._queue)):
                    if self._closed and not self._worker.is_alive():
                        break
                    self._cond.wait(timeout=0.05)
            finally:
                self._drain.discard(slot)
                self._cond.notify_all()

    def close(self):
        """Drain the queue, stop the worker, release the back-end thread.
        Idempotent; ``submit`` afterwards raises."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._worker is not threading.current_thread():
            self._worker.join()
        if self._backend_pool is not None:
            self._backend_pool.shutdown(wait=True)

    def __enter__(self) -> "ContinuousScheduler":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False

    @property
    def pending(self) -> int:
        with self._cond:
            return len(self._queue)

    # ----------------------------------------------------- sizing policy
    def _target_limit(self, rate: float, service_s: float,
                      p99_s: Optional[float] = None) -> int:
        """Wave bucket / active-slot limit from arrival-rate telemetry.

        Little's-law sizing: at ``rate`` arrivals/sec and ``service_s``
        per wave, ``rate * service_s`` turns land during one wave —
        that (x headroom) is the bucket that absorbs the steady state,
        rounded up to the engine's power-of-two jit buckets.  A measured
        turn p99 above ``target_p99_s`` backs the limit off one bucket
        step (smaller waves finish sooner) until the SLO recovers.
        """
        target = min(rate * max(service_s, 1e-4) * self.headroom,
                     self.max_wave)
        # up to one turn a wave, or no reading (NaN): the smallest bucket
        b = layout.next_pow2(math.ceil(target)) if target > 1 else 1
        limit = max(self.min_wave, min(b, self.max_wave))
        if (self.target_p99_s is not None and p99_s is not None
                and p99_s == p99_s and p99_s > self.target_p99_s):
            limit = min(limit, max(self.min_wave, self.wave_limit // 2))
        return limit

    def _adapt_locked(self) -> None:
        if not self.adaptive or self.telemetry.arrivals.count < 8:
            return
        p99 = (self.telemetry.total_s.percentile(99)
               if self.target_p99_s is not None else None)
        self.wave_limit = self._target_limit(
            self.telemetry.arrivals.rate(), self._service_ewma, p99)

    # ---------------------------------------------------- wave selection
    def _select_locked(self):
        """Pick the next wave from the queue (caller holds the lock).

        Returns ``(batch, wait_s)``: a non-empty list of items removed
        from the queue, or ``(None, wait_s)`` when nothing is ready —
        ``wait_s`` is how long to sleep for a pending window hold (None =
        until notified).
        """
        eligible: list[_Item] = []
        seen_slots: set = set()
        for it in self._queue:
            if it.slot is not None:
                if it.slot in self._active_slots or it.slot in seen_slots:
                    seen_slots.add(it.slot)   # preserve per-slot order:
                    continue                  # later items of it stay too
                seen_slots.add(it.slot)
            eligible.append(it)
            if len(eligible) >= self.wave_limit:
                break
        if not eligible:
            return None, None
        drain_ready = [it for it in eligible if it.slot in self._drain]
        drain_only = False
        ready = (self.window_s <= 0 or self._closed or self._flushes > 0
                 or len(self._queue) >= self.wave_limit
                 or any(it.released for it in eligible))
        if not ready:
            age = time.perf_counter() - eligible[0].admitted_at
            if age >= self.window_s:
                ready = True
            elif drain_ready:
                # a drain bypasses the hold for ITS slot only: other
                # sessions' turns keep waiting on their own window
                eligible = drain_ready
                drain_only = True
            else:
                return None, self.window_s - age
        batch = eligible
        taken = set(map(id, batch))
        self._queue = [it for it in self._queue if id(it) not in taken]
        if not drain_only:
            for it in self._queue:
                # a window-mode flush takes the whole queue: anything
                # already admitted when this wave fired owes no further hold
                it.released = True
        for it in batch:
            if it.slot is not None:
                self._active_slots.add(it.slot)
        self._in_wave += 1
        return batch, None

    # ------------------------------------------------------- worker loop
    def _loop(self):
        inflight: Optional[_Inflight] = None
        while True:
            with _LOOP:
                batch = None
                with _AWAIT_TURNS, self._cond:
                    while True:
                        with _ADMIT:
                            batch, wait_s = self._select_locked()
                        if batch is not None or inflight is not None:
                            break
                        if self._closed and not self._queue:
                            self._cond.notify_all()
                            return
                        self._cond.wait(timeout=wait_s)
                nxt = None
                if batch is not None:
                    if self._engine is None:
                        self._run_fn_wave(batch)
                    else:
                        # probe wave t+1 NOW: it only reads cache state,
                        # and wave t's back-end search is still in flight
                        nxt = self._begin_wave(batch)
                if inflight is not None:
                    self._finish_wave(inflight)
                inflight = nxt

    # ------------------------------------------------------ fn-mode wave
    def _run_fn_wave(self, batch: list) -> None:
        t0 = time.perf_counter()
        items = [it.payload for it in batch]
        try:
            results = self._fn(items)
            if len(results) != len(batch):
                raise RuntimeError(
                    f"batch fn returned {len(results)} results for "
                    f"{len(batch)} items")
        except Exception as e:                 # noqa: BLE001
            for it in batch:
                it.future.set_exception(e)
        else:
            for it, res in zip(batch, results):
                if isinstance(res, BaseException):
                    it.future.set_exception(res)
                else:
                    it.future.set_result(res)
        self._wave_done(batch, time.perf_counter() - t0)

    # -------------------------------------------------- engine-mode wave
    def _begin_wave(self, batch: list) -> Optional[_Inflight]:
        """Run the probe phase of a wave; launch its back-end search on
        the side thread when overlapping."""
        t0 = time.perf_counter()
        try:
            ws = self._engine.probe_wave(
                [it.slot for it in batch], [it.payload for it in batch],
                admitted_at=[it.admitted_at for it in batch])
        except Exception as e:                 # noqa: BLE001
            for it in batch:
                it.future.set_exception(e)
            self._wave_done(batch, time.perf_counter() - t0)
            return None
        backend_future = (self._backend_pool.submit(
            self._engine.backend_wave, ws) if self.overlap else None)
        return _Inflight(ws, batch, backend_future, t0)

    def _finish_wave(self, infl: _Inflight) -> None:
        """Join the back-end phase, run the fill phase, resolve waiters.
        An engine exception fails this wave's futures only — the loop
        never wedges."""
        wave = infl.ws.wave_id
        try:
            if infl.backend_future is not None:
                with _JOIN_BACKEND.of(wave):
                    infl.backend_future.result()
            else:
                self._engine.backend_wave(infl.ws)
            turns = self._engine.fill_wave(infl.ws)
        except Exception as e:                 # noqa: BLE001
            turns = [e] * len(infl.items)
        with _DELIVER.of(wave):
            for it, res in zip(infl.items, turns):
                if isinstance(res, BaseException):
                    it.future.set_exception(res)
                else:
                    it.future.set_result(res)
            self._wave_done(infl.items, time.perf_counter() - infl.t_start)

    def _wave_done(self, batch: list, service_s: float) -> None:
        self.telemetry.record_wave(len(batch), service_s)
        alpha = 0.3
        self._service_ewma = (service_s if self._service_ewma == 0.0 else
                              (1 - alpha) * self._service_ewma
                              + alpha * service_s)
        with self._cond:
            for it in batch:
                if it.slot is not None:
                    self._active_slots.discard(it.slot)
            self._in_wave -= 1
            self._adapt_locked()
            self._cond.notify_all()

