"""The L1 session tier: host wrappers over the cache ops.

The port of ``repro.core.cache``'s wrappers:

  * ``MetricCache`` — one conversation's cache (Algorithm 1 for one
    session): ``probe`` is one launch of the single-session probe kernel
    (``kernels.cache_probe.cache_probe``), ``query`` and ``insert`` one
    launch each of the wave kernel in query and insert mode (the scalar
    ``cache_ops`` ops).  The JAX ``use_kernel=`` argument is gone: the port
    has no kernel tiers, and the state's device alone decides (a CUDA
    state launches the kernels, a CPU state runs their plain versions).
  * ``BatchedMetricCache`` — one stacked ``CacheState`` for S concurrent
    sessions on one device: ``probe``, ``query`` and ``insert`` over every
    session at once (the batched ``cache_ops`` ops, one launch each),
    ``gather`` / ``scatter`` of a wave's rows and per-session ``reset``.  ``gather`` copies the wave's rows (the
    cache ops then update that copy in place) and ``scatter`` writes them
    back, in place.  A wave leaves the payload where it is:
    ``gather(..., payload=False)`` copies every leaf but ``doc_emb``, the
    ops read and write the stacked payload through ``rows`` (``wave_rows``)
    and ``scatter`` writes back the rest.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cache_ops import (CacheConfig, CacheState,
                                        ProbeResult, init_batched_cache,
                                        init_cache, insert, insert_batched,
                                        probe_batched, query, query_batched)
from repro_torch.kernels.cache_probe.ops import cache_probe

__all__ = ["MetricCache", "BatchedMetricCache"]


class MetricCache:
    """One session's cache on one device (None means ``cuda``); the ops
    update ``state`` in place."""

    def __init__(self, cfg: CacheConfig, device=None):
        self.cfg = cfg
        self.state = init_cache(cfg, device)
        self.device = self.state.doc_ids.device
        self.total_dropped = 0

    def reset(self):
        self.state = init_cache(self.cfg, self.device)
        self.total_dropped = 0

    @property
    def n_docs(self) -> int:
        return int(self.state.n_docs)

    @property
    def n_queries(self) -> int:
        """Number of *valid* query records (the ring holds the newest)."""
        return min(int(self.state.n_queries), self.cfg.max_queries)

    @property
    def total_queries(self) -> int:
        """Total queries ever recorded, including ring-overwritten ones."""
        return int(self.state.n_queries)

    def _psi(self, psi) -> torch.Tensor:
        return torch.as_tensor(psi, device=self.device).to(torch.float32)

    def probe(self, psi, epsilon=None) -> ProbeResult:
        """The LowQuality test of ``psi`` (dim,): one probe launch."""
        eps = self.cfg.epsilon if epsilon is None else epsilon
        st = self.state
        return ProbeResult(*cache_probe(
            st.q_emb, self._psi(psi), st.q_radius, st.n_queries, eps,
            q_scale=st.q_scale, max_queries=self.cfg.max_queries))

    def query(self, psi, k: int):
        """(scores, dists, ids, slots) of the top k, with the LRU touch."""
        out, self.state = query(self.state, self._psi(psi), k)
        return out

    def insert(self, psi, radius, new_emb, new_ids, record=True):
        """Insert k_c back-end rows (and the (psi, r_a) record)."""
        self.state, dropped = insert(self.state, self.cfg, self._psi(psi),
                                     radius, new_emb, new_ids, record)
        self.total_dropped += int(dropped)

    def memory_bytes(self) -> int:
        """Worst-case occupancy (paper RQ1.C) at the physical extents."""
        return _memory_bytes(self.state)


def _memory_bytes(s: CacheState) -> int:
    return sum(x.numel() * x.element_size() for x in
               (s.doc_emb, s.doc_ids, s.doc_stamp, s.q_emb, s.q_radius,
                s.doc_scale, s.q_scale))


class BatchedMetricCache:
    """The stacked cache state of S sessions on one device; the wave runs
    the ``cache_ops`` batched ops on the rows ``gather`` hands it."""

    def __init__(self, cfg: CacheConfig, n_sessions: int, device=None):
        self.cfg = cfg
        self.n_sessions = n_sessions
        self.state = init_batched_cache(cfg, n_sessions, device)
        self.device = self.state.doc_ids.device
        self.total_dropped = 0
        # one empty row, kept: the sentinels every per-session reset writes
        self._empty = list(init_cache(cfg, self.device))
        # its leaves by dtype: a _foreach_copy_ over one dtype takes
        # PyTorch's fused path, one launch rather than one a leaf
        by_dtype: dict = {}
        for i, x in enumerate(self._empty):
            by_dtype.setdefault(x.dtype, []).append(i)
        self._dtype_groups = list(by_dtype.values())

    def check(self, sessions, dtype=np.int64) -> np.ndarray:
        """``sessions`` as a host index array, checked against the slots."""
        idx = np.asarray(sessions, dtype)
        if idx.size and (idx.min() < 0 or idx.max() >= self.n_sessions):
            raise IndexError(f"sessions {idx} outside [0, {self.n_sessions})")
        return idx

    def _idx(self, sessions, dtype=np.int64) -> torch.Tensor:
        """A device index of ``sessions``: an index tensor already on the
        device is taken as is (its caller checked and copied it)."""
        if isinstance(sessions, torch.Tensor) and \
                sessions.device == self.device:
            return sessions.to(torch.int32 if dtype == np.int32
                               else torch.int64)
        return torch.as_tensor(self.check(sessions, dtype),
                               device=self.device)

    def wave_rows(self, sessions) -> torch.Tensor:
        """The sessions' int32 payload rows: the cache ops' ``rows``."""
        return self._idx(sessions, np.int32)

    def reset(self, sessions=None):
        """Reset all sessions, or just the given host slots, in place: the
        kept empty row is copied into each slot's row views, one
        ``_foreach_copy_`` a dtype, with no index copy, sync or allocation.
        It runs on the current stream, so it lands before any later wave's
        read of the slot."""
        if sessions is None:
            self.state = init_batched_cache(self.cfg, self.n_sessions,
                                            self.device)
            self.total_dropped = 0
            return
        for slot in self.check(sessions).reshape(-1).tolist():
            rows = [x[slot] for x in self.state]
            for group in self._dtype_groups:
                torch._foreach_copy_([rows[i] for i in group],
                                     [self._empty[i] for i in group])

    @property
    def n_docs(self) -> np.ndarray:
        return self.state.n_docs.cpu().numpy()

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def probe(self, psi, epsilon=None) -> ProbeResult:
        """The LowQuality test of every session: psi (S, dim)."""
        eps = self.cfg.epsilon if epsilon is None else epsilon
        return probe_batched(self.state, self._t(psi).to(torch.float32), eps,
                             max_queries=self.cfg.max_queries)

    def query(self, psi, k: int):
        """Every session's (scores, dists, ids, slots) top k, with the LRU
        touch, in place."""
        out, self.state = query_batched(
            self.state, self._t(psi).to(torch.float32), k)
        return out

    def insert(self, psi, radius, new_emb, new_ids, do=None, record=None):
        """Insert each session's k_c back-end rows (and its (psi, r_a)
        record) where ``do`` (and ``record``) say, in place."""
        self.state, dropped = insert_batched(
            self.state, self.cfg, self._t(psi), self._t(radius),
            self._t(new_emb), new_ids, do, record)
        self.total_dropped += int(dropped.sum())

    def memory_bytes(self) -> int:
        """Worst-case occupancy of every session at the physical extents."""
        return _memory_bytes(self.state)

    @property
    def n_queries(self) -> np.ndarray:
        return torch.clamp(self.state.n_queries,
                           max=self.cfg.max_queries).cpu().numpy()

    def gather(self, sessions, payload: bool = True) -> CacheState:
        """A copy of the given sessions' rows (a wave's sub-state).  With
        ``payload=False`` its ``doc_emb`` is the stacked payload itself, not
        a copy, for the ops' ``rows=``."""
        idx = self._idx(sessions)
        return CacheState(*(x if not payload and x is self.state.doc_emb
                            else x[idx] for x in self.state))

    def scatter(self, sessions, sub: CacheState, rows=None):
        """Write a wave's updated sub-state back, in place: its rows
        ``rows`` (all by default; host or device indices) to the given
        sessions.  A payload that
        ``sub`` shares with the stacked state was written in place.  The
        sessions must be distinct: with a repeated index the card keeps an
        unspecified one of its rows."""
        idx = self._idx(sessions)
        for full, part in zip(self.state, sub):
            if part is not full:
                full[idx] = part if rows is None else part[rows]
