"""The L1 session tier: ``BatchedMetricCache`` over the stacked cache ops.

The port of ``repro.core.cache.BatchedMetricCache``: one stacked
``CacheState`` for S concurrent sessions on one device, with ``gather`` /
``scatter`` of a wave's rows and per-session ``reset``.  ``gather`` copies
the wave's rows (the cache ops then update that copy in place) and
``scatter`` writes them back, in place.  The single-session ``MetricCache``
is not part of this port yet.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cache_ops import (CacheConfig, CacheState,
                                        init_batched_cache)

__all__ = ["BatchedMetricCache"]


class BatchedMetricCache:
    """The stacked cache state of S sessions on one device; the wave runs
    the ``cache_ops`` batched ops on the rows ``gather`` hands it."""

    def __init__(self, cfg: CacheConfig, n_sessions: int, device=None):
        self.cfg = cfg
        self.n_sessions = n_sessions
        self.state = init_batched_cache(cfg, n_sessions, device)
        self.device = self.state.doc_ids.device
        self.total_dropped = 0

    def _idx(self, sessions) -> torch.Tensor:
        return torch.as_tensor(np.asarray(sessions, np.int64),
                               device=self.device)

    def reset(self, sessions=None):
        """Reset all sessions, or just the given session indices (in place)."""
        if sessions is None:
            self.state = init_batched_cache(self.cfg, self.n_sessions,
                                            self.device)
            self.total_dropped = 0
            return
        idx = self._idx(sessions)
        fresh = init_batched_cache(self.cfg, 1, self.device)
        for full, one in zip(self.state, fresh):
            full[idx] = one

    @property
    def n_docs(self) -> np.ndarray:
        return self.state.n_docs.cpu().numpy()

    @property
    def n_queries(self) -> np.ndarray:
        return torch.clamp(self.state.n_queries,
                           max=self.cfg.max_queries).cpu().numpy()

    def gather(self, sessions) -> CacheState:
        """A copy of the given sessions' rows (a wave's sub-state)."""
        idx = self._idx(sessions)
        return CacheState(*(x[idx] for x in self.state))

    def scatter(self, sessions, sub: CacheState):
        """Write a wave's updated sub-state back, in place."""
        idx = self._idx(sessions)
        for full, part in zip(self.state, sub):
            full[idx] = part
