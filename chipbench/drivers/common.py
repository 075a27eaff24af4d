"""What the drivers share: the run's context and the wrappers the
benchmark puts around its calls into the program."""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time
from typing import Callable

from chipbench.record import Call

# seconds of the window a traced run profiles: long enough for some
# thousands of kernels and tens of waves, short enough that reading the
# trace keeps the run well inside its time limit
TRACE_WINDOW_S = 3.0


@dataclasses.dataclass
class Ctx:
    cfg: dict             # the configuration file
    traffic: dict         # the mix, with the cell's overrides
    seed: int
    seconds: float
    device: str
    tracer: object        # trace.Tracer
    log: Callable[[str], None]


class Timed:
    """A callable of the program wrapped in a benchmark range; each call is
    kept as a ``Call`` (its range instance ``<prefix>#<n>``) together with
    what ``work(args, result)`` says it asked for."""

    def __init__(self, fn: Callable, prefix: str, tracer,
                 work: Callable | None = None, keep: bool = False):
        self.fn, self.prefix, self.tracer = fn, prefix, tracer
        self.work = work
        self.keep = keep
        self.calls: list = []
        self.kept: list = []
        self._n = itertools.count()

    def __call__(self, *args):
        name = f"{self.prefix}#{next(self._n)}"
        t0 = time.perf_counter()
        with self.tracer.range(name):
            out = self.fn(*args)
        t1 = time.perf_counter()
        flops, nbytes = self.work(args, out) if self.work else (0.0, 0.0)
        self.calls.append(Call(name, t0, t1, flops, nbytes))
        if self.keep:
            self.kept.append((args, out))
        return out

    def reset(self) -> None:
        self.calls.clear()
        self.kept.clear()


class Profiling:
    """Starts the tracer's profile at ``t0`` and stops it at ``t1`` from
    the thread that polls ``tick``."""

    def __init__(self, tracer, t0: float, t1: float):
        self.tracer, self.t0, self.t1 = tracer, t0, t1
        self.stack = contextlib.ExitStack()
        self.state = "before" if tracer.enabled else "done"

    def tick(self, now: float | None = None) -> None:
        now = time.perf_counter() if now is None else now
        if self.state == "before" and now >= self.t0:
            self.stack.enter_context(self.tracer.profile())
            self.state = "on"
        elif self.state == "on" and now >= self.t1:
            self.stop()

    def stop(self) -> None:
        if self.state == "on":
            self.stack.close()
        self.state = "done"


def trace_span(ctx: Ctx, t_open: float) -> tuple[float, float]:
    """The traced part of the window: its last ``TRACE_WINDOW_S`` (the
    trace is read when the profiler stops, which holds up the load; at the
    close that falls outside the window)."""
    w = min(TRACE_WINDOW_S, ctx.seconds)
    t1 = t_open + ctx.seconds
    return t1 - w, t1


def no_tf32() -> None:
    """The configurations' f32 products run in full float32."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
