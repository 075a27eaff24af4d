"""Ranges the benchmark opens around its calls into the program, and the
reading of a ``torch.profiler`` trace taken over part of the window.

``Tracer.range(name)`` is a ``record_function`` range when tracing and
costs nothing otherwise.  Range names start with ``cb.``; an instance
name may end in ``#<n>`` (the n-th call), which the readers use to find
that call's shape.  ``Tracer.profile()`` wraps the traced part of the
window; ``Tracer.read()`` then gives:

  * ``window_s``: the traced window (the ``cb.window`` range);
  * ``busy_s``: seconds in which some device activity (kernel, copy,
    fill) ran inside it;
  * ``device_by_range``: {range instance: device seconds of the kernels
    launched inside it, on any thread};
  * ``device_ops``: device seconds by activity name;
  * ``idle_by_host``: idle device seconds by the benchmark range active on
    the host at the time ("host" where none was).
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
from typing import Optional

from chipbench import stats


@dataclasses.dataclass
class TraceReading:
    window_s: float
    busy_s: float
    device_by_range: dict
    device_ops: dict
    idle_by_host: dict


def _base(name: str) -> str:
    return name.split("#", 1)[0]


class Tracer:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.reading: Optional[TraceReading] = None

    def range(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    def warm(self) -> None:
        """Start and stop the profiler once: its first start initialises
        CUPTI for seconds, which must not eat the traced window."""
        if self.enabled:
            with self.profile():
                pass
            self.prof = None

    @contextlib.contextmanager
    def profile(self):
        """Profile the enclosed part of the window (no-op when off)."""
        if not self.enabled:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        kw = {}
        try:
            from torch._C._profiler import _ExperimentalConfig
            kw["experimental_config"] = _ExperimentalConfig(
                profile_all_threads=True)
        except (ImportError, TypeError):
            pass
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts, **kw) as prof:
            with record_function("cb.window"):
                yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        self.prof = prof

    def read(self) -> Optional[TraceReading]:
        if self.prof is None:
            return None
        if self.reading is None:
            self.reading = read_events(
                self.prof.profiler.kineto_results.events())
        return self.reading


def read_events(events) -> TraceReading:
    """Reduce the profiler's kineto events to a ``TraceReading``.

    Each benchmark range also appears on the device timeline, spanning
    the device work launched inside it (the profiler's GPU user
    annotations).  A device activity is charged to the shortest such span
    that holds its midpoint: spans of calls on other threads can overlap
    (the scheduler overlaps a wave's search with the next wave's encoder
    on one stream), and the shorter span is the one launched in between.
    An activity of another range inside a span is charged to that span,
    which can only lower the span's share of a peak."""
    window = None
    host: list = []              # (start, end, name): benchmark ranges
    spans: list = []             # the same ranges on the device timeline
    device = []
    for e in events:
        name = e.name()
        on_host = str(e.device_type()).endswith("CPU")
        if name == "cb.window":
            if on_host:
                window = (e.start_ns(), e.end_ns())
        elif name.startswith("cb."):
            (host if on_host else spans).append((e.start_ns(), e.end_ns(),
                                                 name))
        elif not on_host:
            device.append((e.start_ns(), e.end_ns(), name))
    if window is None:
        raise RuntimeError("the trace holds no cb.window range")
    lo, hi = window
    inside = [(max(s, lo), min(t, hi), n) for s, t, n in device
              if t > lo and s < hi]
    busy = stats.covered(((s, t) for s, t, _ in inside), lo, hi)
    ops: dict = {}
    for s, t, n in inside:
        ops[n] = ops.get(n, 0.0) + (t - s) / 1e9
    spans.sort()
    by_range: dict = {}
    for s, t, _n in inside:
        r = _shortest(spans, (s + t) // 2)
        if r is not None:
            by_range[r] = by_range.get(r, 0.0) + (t - s) / 1e9
    host.sort()
    idle: dict = {}
    gap_list = stats.gaps(((s, t) for s, t, _ in inside), lo, hi)
    mids = [(g0 + g1) / 2 for g0, g1 in gap_list]
    best: list = [None] * len(gap_list)
    for s, t, n in host:
        for i in range(bisect.bisect_left(mids, s),
                       bisect.bisect_right(mids, t)):
            if best[i] is None or t - s < best[i][1] - best[i][0]:
                best[i] = (s, t, n)
    for (g0, g1), b in zip(gap_list, best):
        label = _base(b[2]) if b else "host"
        idle[label] = idle.get(label, 0.0) + (g1 - g0) / 1e9
    return TraceReading(window_s=(hi - lo) / 1e9, busy_s=busy / 1e9,
                        device_by_range=by_range, device_ops=ops,
                        idle_by_host=idle)


def _shortest(spans: list, t: int, walk: int = 64) -> Optional[str]:
    """The shortest of the last ``walk`` spans (sorted by start) that
    started by ``t`` and hold it."""
    i = bisect.bisect_right(spans, (t, float("inf"), ""))
    best = None
    for s, e, n in spans[max(i - walk, 0):i]:
        if e >= t and (best is None or e - s < best[1] - best[0]):
            best = (s, e, n)
    return best[2] if best else None


def top(d: dict, n: int = 10, width: int = 120) -> list:
    """The ``n`` largest entries of {name: seconds} as [name, seconds]."""
    return [[k[:width], v] for k, v in
            sorted(d.items(), key=lambda kv: -kv[1])[:n]]
