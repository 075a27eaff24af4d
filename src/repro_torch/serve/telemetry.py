"""Serving telemetry: spans of the serving path, per-turn latency and rates.

The paper's case is *latency* — the cache exists so a conversational turn
answers fast — so the serving tier must be able to state a p99 for a
single turn, and say where a slow turn's time went: in the device's work,
in the host's launches, in a blocking copy between the two, or in a pass
of Python's collector.

  * ``SPANS`` — the process's one ``SpanLog``: every layer boundary of the
    serving path records a span (name, start, end, thread, parent span,
    and the wave or request it belongs to) into a preallocated ring of
    numpy arrays.  Names start with ``serve.``; ``serve.sync.<site>`` is a
    blocking host<->device copy (``SyncSite``), ``serve.gc`` a pass of the
    collector.  While a ``torch.profiler`` runs each span also opens a
    profiler range under its name, which puts the program's spans on the
    device trace's clock.
  * ``TurnSpans`` — one turn's latency decomposition: queue wait
    (admission -> wave start), probe (the encoder and the L1/L2 cache
    launches), backend (router round-trip over the miss subset), insert
    (fused insert+query close), and the admission-to-resolution total.
    Spans other than queue wait are wave-level (every turn of a wave
    shares them, read off the wave's phase spans); the queue wait and
    total are strictly per turn.
  * ``RingPercentiles`` — a fixed-capacity ring buffer with nearest-rank
    percentile estimates over the most recent window.
  * ``EwmaRate`` — an exponentially weighted arrival-rate estimator whose
    smoothing follows a wall-clock *horizon* (irregular arrival spacing is
    handled by weighting each observation with ``1 - exp(-dt/horizon)``).
    The scheduler sizes wave buckets and active engine slots from it.
  * ``EXPERT_LOAD`` — the process's one ``ExpertLoad``: the routed real
    tokens of each (layer, expert) of the dropless MoE path
    (``models.moe.moe_ffn_dropless``), and the pad rows it skipped, summed
    on the device with no sync.
  * ``ServeTelemetry`` — what the engine and scheduler write per turn and
    per wave (counts, the turn totals the scheduler's p99 back-off reads,
    arrivals, faults), and ``summary()``: the operator's view, every span
    name's count and p50/p95/p99 from the span log beside those, and the
    expert load.

Recording a span never touches the device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import math
import threading
import time
from typing import Optional

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["TurnSpans", "RingPercentiles", "EwmaRate", "ServeTelemetry",
           "SpanLog", "SpanKind", "SyncSite", "Spans", "SPANS",
           "strict_syncs", "ExpertLoad", "EXPERT_LOAD"]


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


# ------------------------------------------------------------------ spans
_clock = time.perf_counter_ns
_thread_id = threading.get_ident


def _open_range(name: str):
    """A profiler range under ``name``, entered (only while a profiler
    runs).  A function-scope range: it lies on the host's timeline of the
    trace, the same clock as the device's activities, and projects no
    range of its own onto the device's timeline."""
    rf = torch._C._profiler._RecordFunctionFast(name)
    rf.__enter__()
    return rf


class _ThreadState(threading.local):
    cur = -1        # token of the innermost span open on this thread, or
                    # of the span adopted from the thread it works for
    wave = -1       # id of the wave or request the thread works for


@dataclasses.dataclass
class Spans:
    """Spans read out of the log, one entry each (numpy arrays), in the
    order they began; a span still open has ``end < start``."""

    names: list          # kind id -> span name
    token: np.ndarray    # the span's number in the log
    kind: np.ndarray
    start: np.ndarray    # time.perf_counter_ns
    end: np.ndarray
    thread: np.ndarray   # threading.get_ident of its thread
    parent: np.ndarray   # the parent span's token, -1 for none
    wave: np.ndarray     # the wave's or request's id, -1 for none

    def of(self, name: str) -> np.ndarray:
        """Mask of the closed spans named ``name``, or, for a name ending
        in a dot such as ``serve.sync.``, of that family."""
        ids = [i for i, n in enumerate(self.names) if n == name
               or (name.endswith(".") and n.startswith(name))]
        return np.isin(self.kind, ids) & (self.end >= self.start)

    def seconds(self) -> np.ndarray:
        return (self.end - self.start) * 1e-9


class SpanLog:
    """A ring of the most recent ``capacity`` spans in preallocated numpy
    arrays, written by any thread.  Recording a span stores into the
    arrays and keeps no Python object: a span costs two clock reads, the
    check of whether a profiler runs, and the stores.

    ``kind(name)`` makes a span name's ``SpanKind`` (once, at import);
    ``with kind:`` records one span on this thread, a child of the span
    open there, in the wave or request the thread works for;
    ``with kind.of(wave):`` names the wave.  ``new_id()`` numbers a wave or
    request.  Work handed to another thread carries ``current()`` along,
    and the other thread ``adopt``s it: its spans then name that span as
    their parent and belong to its wave.

    ``SPANS`` records each pass of Python's collector as ``serve.gc`` on
    the thread it holds up, through the one ``gc.callbacks`` entry the
    module installs.
    """

    def __init__(self, capacity: int = 1 << 17):
        cap = 1 << max(int(capacity) - 1, 1).bit_length()
        self.capacity, self._mask = cap, cap - 1
        self._seq = np.full((cap,), -1, np.int64)
        self._kind = np.zeros((cap,), np.int32)
        self._start = np.zeros((cap,), np.int64)
        self._end = np.zeros((cap,), np.int64)
        self._thread = np.zeros((cap,), np.int64)
        self._parent = np.full((cap,), -1, np.int64)
        self._wave = np.full((cap,), -1, np.int64)
        # writers store through memoryviews of the arrays (the cheaper
        # store); readers copy the arrays
        self._w_seq, self._w_kind, self._w_start, self._w_end, \
            self._w_thread, self._w_parent, self._w_wave = (
                memoryview(a) for a in (self._seq, self._kind, self._start,
                                        self._end, self._thread,
                                        self._parent, self._wave))
        self._tokens = itertools.count()
        self._ids = itertools.count()
        self._tls = _ThreadState()
        self._names: list = []
        self._kinds: dict = {}
        self._kind_lock = threading.Lock()
        self._ranges: dict = {}          # token -> open profiler range
        self._strict = False
        self._relaxed = 0
        self._strict_lock = threading.Lock()
        self._gc_token = -1
        self._gc = self.kind("serve.gc")

    # ------------------------------------------------------------ writers
    def kind(self, name: str, cls=None) -> "SpanKind":
        """The span kind named ``name`` (one per name)."""
        with self._kind_lock:
            k = self._kinds.get(name)
            if k is None:
                k = (cls or SpanKind)(self, len(self._names), name)
                self._names.append(name)
                self._kinds[name] = k
            return k

    def new_id(self) -> int:
        """A fresh id for a wave or a request."""
        return next(self._ids)

    def current(self) -> int:
        """The token of the span open on this thread (-1: none)."""
        return self._tls.cur

    def adopt(self, tok: int) -> None:
        """Work on this thread for span ``tok`` of another thread (or, -1,
        for none): later spans here are its children, in its wave."""
        tls = self._tls
        tls.cur = tok
        i = tok & self._mask
        tls.wave = self._w_wave[i] if tok >= 0 and self._w_seq[i] == tok \
            else -1

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_token = self._gc.__enter__()
        elif self._gc_token >= 0:
            self._gc_token = -1
            self._gc.__exit__()

    # ------------------------------------------------------------ readers
    def duration_s(self, tok: int) -> float:
        """Seconds span ``tok`` lasted (NaN if open or overwritten)."""
        i = tok & self._mask
        if self._w_seq[i] != tok or self._w_end[i] < self._w_start[i]:
            return float("nan")
        return (self._w_end[i] - self._w_start[i]) * 1e-9

    def start_s(self, tok: int) -> float:
        """Span ``tok``'s start on ``time.perf_counter``'s scale (NaN if
        overwritten)."""
        i = tok & self._mask
        if self._w_seq[i] != tok:
            return float("nan")
        return self._w_start[i] * 1e-9

    def window(self, t0_ns: int, t1_ns: int) -> Optional[Spans]:
        """The spans that began in [t0_ns, t1_ns] (``perf_counter_ns``),
        or None when the ring no longer holds all of them."""
        seq = self._seq.copy()
        held = seq >= 0
        if not held.any():
            return self._select(held)
        n = int(seq.max()) + 1
        if n > self.capacity:
            oldest = (n - self.capacity) & self._mask
            if int(self._start[oldest]) > t0_ns:
                return None
        start = self._start.copy()
        return self._select(held & (start >= t0_ns) & (start <= t1_ns),
                            seq, start)

    def all(self) -> Spans:
        """Every span the ring holds."""
        return self._select(self._seq >= 0)

    def _select(self, mask, seq=None, start=None) -> Spans:
        seq = self._seq if seq is None else seq
        start = self._start if start is None else start
        order = np.argsort(seq[mask], kind="stable")
        pick = lambda a: a[mask][order]          # noqa: E731
        return Spans(names=list(self._names), token=pick(seq),
                     kind=pick(self._kind), start=pick(start),
                     end=pick(self._end), thread=pick(self._thread),
                     parent=pick(self._parent), wave=pick(self._wave))

    def summary(self) -> dict:
        """{span name: count and nearest-rank p50/p95/p99 seconds} over
        the closed spans the ring holds."""
        sp = self.all()
        done = sp.end >= sp.start
        out = {}
        for k, name in enumerate(sp.names):
            xs = np.sort(sp.seconds()[done & (sp.kind == k)])
            if xs.size:
                out[name] = {"count": int(xs.size), **{
                    f"p{p}": float(xs[max(1, math.ceil(p / 100 * xs.size))
                                      - 1]) for p in (50, 95, 99)}}
        return out

    # -------------------------------------------------- strict sync checks
    def _relax(self, d: int) -> None:
        with self._strict_lock:
            self._relaxed += d
            if self._strict:
                torch.cuda.set_sync_debug_mode(
                    0 if self._relaxed else "error")


class SpanKind:
    """A span name of the log; see ``SpanLog``.  ``__enter__`` opens a
    span on this thread and returns its token; ``__exit__`` closes the
    thread's open span, and the thread returns to its parent span and the
    parent's wave."""

    __slots__ = ("log", "id", "name", "_tls")

    def __init__(self, log: SpanLog, kind_id: int, name: str):
        self.log, self.id, self.name = log, kind_id, name
        self._tls = log._tls

    def of(self, wave: int) -> "SpanKind":
        """The next span of this kind on this thread belongs to ``wave``."""
        self._tls.wave = wave
        return self

    def __enter__(self) -> int:
        # a slot's old end needs no clearing: it predates the new start
        log, tls = self.log, self._tls
        tok = next(log._tokens)
        i = tok & log._mask
        log._w_seq[i] = tok
        log._w_kind[i] = self.id
        log._w_thread[i] = _thread_id()
        log._w_parent[i] = tls.cur
        log._w_wave[i] = tls.wave
        tls.cur = tok
        if _autograd_profiler._is_profiler_enabled:
            log._ranges[tok] = _open_range(self.name)
        log._w_start[i] = _clock()
        return tok

    def __exit__(self, *exc) -> None:
        t = _clock()
        log, tls = self.log, self._tls
        tok = tls.cur
        if log._ranges:
            rf = log._ranges.pop(tok, None)
            if rf is not None:
                rf.__exit__(None, None, None)
        i = tok & log._mask
        if log._w_seq[i] != tok:         # overwritten while open
            tls.cur = tls.wave = -1
            return
        log._w_end[i] = t
        p = log._w_parent[i]
        tls.cur = p
        j = p & log._mask
        tls.wave = log._w_wave[j] if p >= 0 and log._w_seq[j] == p else -1


class SyncSite(SpanKind):
    """One place where the host waits for the device: a blocking copy,
    recorded as a ``serve.sync.<site>`` span.  Every blocking copy of the
    serving path goes through ``host`` or ``device``, so the waits of a
    wave are counted and timed where they happen."""

    __slots__ = ()

    def host(self, t: torch.Tensor) -> np.ndarray:
        """``t`` on the host, as numpy."""
        with self:
            return t.cpu().numpy()

    def device(self, x, device, dtype=None) -> torch.Tensor:
        """``x`` (host data) as a tensor on ``device``."""
        with self:
            return torch.as_tensor(x, dtype=dtype, device=device)

    def __enter__(self) -> int:
        tok = SpanKind.__enter__(self)
        if self.log._strict:
            self.log._relax(1)
        return tok

    def __exit__(self, *exc) -> None:
        if self.log._strict:
            self.log._relax(-1)
        SpanKind.__exit__(self)


def sync_site(site: str) -> SyncSite:
    """The sync site ``serve.sync.<site>``."""
    return SPANS.kind(f"serve.sync.{site}", SyncSite)


@contextlib.contextmanager
def strict_syncs():
    """On the card: any blocking host<->device sync outside a
    ``serve.sync.*`` span raises (CUDA's sync debug mode at "error",
    relaxed inside the sync spans).  The mode is the process's, so a sync
    span open on one thread lets another thread's sync pass too."""
    SPANS._strict = True
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        SPANS._strict = False
        torch.cuda.set_sync_debug_mode(0)


SPANS = SpanLog()
gc.callbacks.append(SPANS._on_gc)


class ExpertLoad:
    """Routed real tokens of each (layer, expert), summed on the device.

    ``add(layer, counts, top_k)`` takes a MoE layer's (E + 1,) int64
    choice counts on the device, the last entry its pad rows' choices
    (``top_k`` a pad row), and adds them in place to the row of ``layer``:
    one launch, no sync (the table grows, with an allocation, only when a
    layer or width is new: in a model's first forward).  ``snapshot()`` is
    a device copy of the table (no sync); ``read(since, until)`` brings the
    table (or the snapshot ``until``), less the snapshot ``since``, to the
    host (a sync: read it after the window)."""

    def __init__(self):
        self._counts: Optional[torch.Tensor] = None   # (layers, E + 1)
        self._top_k: dict = {}                        # layer -> top_k
        self._lock = threading.Lock()

    def add(self, layer: int, counts: torch.Tensor, top_k: int) -> None:
        c = self._counts
        if c is None or layer >= c.shape[0] or c.shape[1] != counts.numel() \
                or c.device != counts.device:
            with self._lock:
                c = self._grow(layer, counts)
        self._top_k[layer] = top_k
        c[layer].add_(counts)

    def _grow(self, layer: int, counts: torch.Tensor) -> torch.Tensor:
        """A table with a row for ``layer``, kept rows carried over; a
        normal tensor even under ``inference_mode`` (the encoder's), so
        that a forward outside it can add to it too."""
        c = self._counts
        with torch.inference_mode(False):
            new = torch.zeros((layer + 1, counts.numel()), dtype=torch.int64,
                              device=counts.device)
            if c is not None and c.shape[1] == counts.numel() \
                    and c.device == counts.device:
                new[:c.shape[0]] = c
        self._counts = new
        return new

    def snapshot(self) -> Optional[torch.Tensor]:
        c = self._counts
        return None if c is None else c.clone()

    def read(self, since: Optional[torch.Tensor] = None,
             until: Optional[torch.Tensor] = None) -> Optional[dict]:
        """{"routed": (layers, E) routed real tokens, "pad_rows": (layers,)
        pad rows skipped}, as numpy, of the MoE layers seen (the rows of
        other layers are zero), less ``since``; None before any."""
        c = self._counts if until is None else until
        if c is None:
            return None
        c = c.cpu().numpy()
        if since is not None:
            s = since.cpu().numpy()
            c = c - np.pad(s, ((0, c.shape[0] - s.shape[0]), (0, 0)))
        k = np.array([self._top_k.get(i, 1) for i in range(c.shape[0])])
        return {"routed": c[:, :-1], "pad_rows": c[:, -1] // k}

    def summary(self) -> Optional[dict]:
        """Per MoE layer: the routed real tokens, the busiest expert's over
        the mean, and the pad rows skipped (None before any)."""
        got = self.read()
        if got is None:
            return None
        out = {}
        for layer in sorted(self._top_k):
            r = got["routed"][layer]
            mean = r.mean()
            out[layer] = {"routed": int(r.sum()),
                          "max_over_mean": float(r.max() / mean) if mean
                          else float("nan"),
                          "pad_rows": int(got["pad_rows"][layer])}
        return out


EXPERT_LOAD = ExpertLoad()


class ServeTelemetry:
    """What the serving path writes per turn and per wave, and the
    operator's ``summary()``.

    Writers: ``BatchedEngine.fill_wave`` records one ``TurnSpans`` per
    resolved turn (its total feeds ``total_s``, which the scheduler's
    ``target_p99_s`` back-off reads); ``ContinuousScheduler`` records
    arrivals (for the EWMA) and one call per wave; the router and engine
    count faults.  Spans go to the process's ``SPANS``, which every
    ``ServeTelemetry`` shares.
    """

    def __init__(self, capacity: int = 4096, ewma_horizon_s: float = 1.0):
        self.total_s = RingPercentiles(capacity)
        self.arrivals = EwmaRate(ewma_horizon_s)
        self.turns = 0
        self.waves = 0
        # fault-domain counters (breaker transitions, shed / degraded /
        # rejected-answer / stale-served / quarantined events) — written
        # by the router and engine
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
        self.total_s.add(spans.total_s)

    def record_wave(self, size: int, service_s: float) -> None:
        self.waves += 1

    # ------------------------------------------------------------ readers
    def summary(self) -> dict:
        """Turns, waves, the arrival rate, the turn totals' p50/p95/p99,
        every span name's count and p50/p95/p99 (``SPANS.summary()``, the
        process's spans), the fault counters, and the dropless MoE path's
        load per layer (``EXPERT_LOAD.summary()``, read from the device:
        call it after the window).  Seconds throughout."""
        with self._fault_lock:
            faults = dict(self.faults)
            transitions = self.breaker_transitions
        return {
            "turns": self.turns,
            "waves": self.waves,
            "arrival_rate_hz": self.arrivals.rate(),
            "turn_total_s": self.total_s.summary(),
            "spans": SPANS.summary(),
            "faults": faults,
            "breaker_transitions": transitions,
            "expert_load": EXPERT_LOAD.summary(),
        }
