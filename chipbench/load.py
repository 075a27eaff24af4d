"""The one traffic generator: it reads a mix's parameters (a
``traffic/<mix>.json`` file, with the cell's ``workloads/<cell>.json``
laid over it) and the run's seed, and gives the drivers what to send and
when.

``kind`` "conversations": conversations over a pool of token scripts.
  * ``loop`` "open": conversations arrive as a Poisson process at
    ``conversations_per_s``.  Over the ramp and the window together it is
    conditioned on its mean count: that many arrivals at independent
    uniform times, which is a Poisson process given its count, with its
    bursts at every scale below the run's length, so that seeds change
    the order and the timing of the load and not its amount; after the
    window, exponential gaps.  ``loop`` "closed": ``clients`` clients
    each start their next conversation the moment the last one ends.
  * each conversation has ``turns`` turns; the next turn is due an
    exponential think time of mean ``think_mean_s`` after the answer
    (0: at once).
  * ``ramp_s``: seconds of load before the window opens.
  * ``sample``: conversations the check compares, drawn from the seed
    among those whose turns all fell in the window.
``kind`` "histories": ``pool`` requests of ``batch`` item histories each,
sent back to back by ``clients`` (1) client(s); ``sample`` requests are
compared.

A request's latency runs from the moment it was due: in an open loop its
scheduled time, in a closed loop the moment its client sent it.
"""

from __future__ import annotations

import dataclasses
import heapq
import threading
import time
from typing import Callable, Optional

import numpy as np

from chipbench.inputs import sub_seed


@dataclasses.dataclass
class ConversationPlan:
    scripts: np.ndarray        # (n,) script of conversation i
    arrivals: Optional[np.ndarray]   # (n,) seconds after the load starts
    think: np.ndarray          # (n, turns) seconds before turn t (t >= 1)
    turns: int
    clients: int


def conversation_plan(tr: dict, n_scripts: int, horizon_s: float,
                      seed: int, counted_s: float) -> ConversationPlan:
    """Every conversation the load may start within ``horizon_s``; an open
    loop's first ``counted_s`` seconds (the ramp and the window) hold the
    rate's count of arrivals."""
    rng = np.random.default_rng(sub_seed(seed, "load"))
    turns = int(tr["turns"])
    if tr["loop"] == "open":
        rate = float(tr["conversations_per_s"])
        counted_s = min(counted_s, horizon_s)
        head = counted_s * np.sort(rng.random(int(round(rate * counted_s))))
        tail = counted_s + np.cumsum(rng.exponential(
            1.0 / rate, int(rate * (horizon_s - counted_s) * 1.5) + 16))
        arrivals = np.concatenate([head, tail[tail < horizon_s]])
        n = arrivals.size
        clients = 0
    else:
        clients = int(tr["clients"])
        # a closed loop starts at most a conversation a turn a client
        n = int(max(horizon_s * 4000, 4096))
        arrivals = None
    think = (rng.exponential(tr["think_mean_s"], (n, turns))
             if tr["think_mean_s"] > 0 else np.zeros((n, turns)))
    return ConversationPlan(scripts=rng.integers(0, n_scripts, n),
                            arrivals=arrivals, think=think, turns=turns,
                            clients=clients)


def sample(candidates, n: int, seed: int, salt: str) -> list:
    """``n`` of ``candidates`` (all when fewer), drawn from the seed."""
    candidates = list(candidates)
    if len(candidates) <= n:
        return candidates
    rng = np.random.default_rng(sub_seed(seed, salt))
    pick = rng.choice(len(candidates), n, replace=False)
    return [candidates[i] for i in sorted(pick)]


class EventLoop:
    """Runs timed actions in the thread that calls ``run``; other threads
    hand it work with ``post`` (a completion callback of the system under
    test must not block its caller).

    A timed action is ``act(t, *action)`` with ``action`` plain numbers:
    an action waiting in the heap is a tuple of numbers, which Python's
    cyclic collector stops tracking, so thousands of them waiting never
    add to a pass of the collector (a pass holds up every thread of the
    process, the system's too)."""

    def __init__(self, act: Callable):
        self.act = act
        self._heap: list = []
        self._posted: list = []
        self._seq = 0
        self._cond = threading.Condition()
        self.lateness: list = []      # seconds each timed action ran late

    def at(self, t: float, *action) -> None:
        with self._cond:
            self._seq += 1
            heapq.heappush(self._heap, (t, self._seq) + action)
            self._cond.notify()

    def post(self, fn: Callable) -> None:
        with self._cond:
            self._posted.append(fn)
            self._cond.notify()

    def run(self, done: Callable[[], bool], poll_s: float = 0.05) -> None:
        """Run actions until ``done()`` holds."""
        while not done():
            with self._cond:
                now = time.perf_counter()
                if not self._posted and (not self._heap
                                         or self._heap[0][0] > now):
                    wait = poll_s if not self._heap else min(
                        poll_s, self._heap[0][0] - now)
                    self._cond.wait(max(wait, 0.0))
                posted, self._posted = self._posted, []
                due = []
                now = time.perf_counter()
                while self._heap and self._heap[0][0] <= now:
                    due.append(heapq.heappop(self._heap))
            for fn in posted:
                fn()
            for entry in due:
                self.lateness.append(time.perf_counter() - entry[0])
                self.act(entry[0], *entry[2:])
