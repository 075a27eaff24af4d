"""What a run leaves for the metric readers and the check."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(slots=True)
class Request:
    due: float                       # when it was due (perf_counter)
    done: Optional[float] = None     # when its answer came
    ok: bool = False                 # answered, not degraded
    measured: bool = False           # due inside the window
    hit: Optional[bool] = None       # answered by the cache
    turn: int = 0                    # turn of its conversation
    conv: int = -1                   # its conversation (or request number)
    answer: object = None            # what the program answered

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.done is None else self.done - self.due


@dataclasses.dataclass
class Call:
    """One call into a layer the benchmark times: its range instance name,
    host interval, and the work it was asked for."""

    name: str
    t0: float
    t1: float
    flops: float = 0.0
    nbytes: float = 0.0


@dataclasses.dataclass
class RunRecord:
    t_open: float
    t_close: float
    setup_s: float = 0.0
    requests: list = dataclasses.field(default_factory=list)
    spans: list = dataclasses.field(default_factory=list)   # TurnSpans
    waves: list = dataclasses.field(default_factory=list)   # dicts
    calls: dict = dataclasses.field(default_factory=dict)   # kind -> [Call]
    model_flops: float = 0.0     # model flops of the window's requests
    service_s: float = 0.0       # seconds the system spent serving them
    trace: object = None         # trace.TraceReading, traced runs only
    notes: dict = dataclasses.field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open

    def in_window(self, t: Optional[float]) -> bool:
        return t is not None and self.t_open <= t <= self.t_close

    def measured(self) -> list:
        return [r for r in self.requests if r.measured]

    def completed(self) -> list:
        """Measured requests that were answered soundly."""
        return [r for r in self.requests if r.measured and r.ok]
