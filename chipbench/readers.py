"""Helpers the metric readers in ``metrics/`` share."""

from __future__ import annotations

from typing import Optional

from chipbench import hardware, stats


def latencies_ms(run) -> list:
    """Latency of every request due in the window and answered soundly."""
    return [r.latency_s * 1e3 for r in run.completed()]


def percent(x: Optional[float]) -> Optional[float]:
    return None if x is None else 100.0 * x


def device_share(run, kind: str, least_time) -> Optional[float]:
    """Share of the device time of the ``kind`` calls inside the traced
    window that ``least_time(call)`` accounts for; None without such
    calls in the trace."""
    tr = run.trace
    if tr is None:
        return None
    need = spent = 0.0
    for c in run.calls.get(kind, []):
        dev_s = tr.device_by_range.get(c.name)
        if dev_s:
            need += least_time(c)
            spent += dev_s
    return need / spent if spent > 0 else None


def tf32_share(run, kind: str) -> Optional[float]:
    """Operations of the ``kind`` calls at the TF32 peak over their device
    time."""
    return device_share(run, kind, lambda c: c.flops / hardware.TF32_FLOPS)


def roofline_share(run, kind: str) -> Optional[float]:
    """Least time (operations at the TF32 peak, bytes at HBM bandwidth)
    of the ``kind`` calls over their device time."""
    return device_share(run, kind,
                        lambda c: hardware.least_time(c.flops, c.nbytes))


def span_percentile(values, p: float) -> Optional[float]:
    got = stats.percentile(values, p)
    return None if got is None else got * 1e3
