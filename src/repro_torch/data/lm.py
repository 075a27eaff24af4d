"""Deterministic synthetic LM token pipeline (a copy of ``repro.data.lm``).

Markov-chain tokens (not uniform noise), drawn with the JAX package's
numpy calls in the same order, so both packages give the same tokens from
the same spec; here they come back as int32 tensors on a device.  Each
process materializes only its slice of the global batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.dispatch import resolve_device

__all__ = ["LMBatchSpec", "TokenStream"]


@dataclasses.dataclass
class LMBatchSpec:
    global_batch: int
    seq_len: int
    vocab_size: int
    seed: int = 0


class TokenStream:
    """Stateless per-step batches: batch(step) is reproducible and identical
    across restarts — a checkpoint only needs the step counter.  Batches
    land on ``device`` (None means ``cuda``)."""

    def __init__(self, spec: LMBatchSpec, n_states: int = 64,
                 process_index: int = 0, process_count: int = 1, *,
                 device=None):
        self.spec = spec
        self.device = resolve_device(device)
        rng = np.random.default_rng(spec.seed)
        # sparse-ish Markov transition over a small state space mapped to vocab
        self.proj = rng.integers(0, spec.vocab_size, n_states).astype(np.int32)
        trans = rng.dirichlet(np.full(n_states, 0.3), size=n_states)
        self.trans_cum = np.cumsum(trans, axis=1).astype(np.float32)
        self.n_states = n_states
        assert spec.global_batch % process_count == 0
        self.local_batch = spec.global_batch // process_count
        self.process_index = process_index

    def batch_numpy(self, step: int) -> dict:
        """The batch of ``step`` as numpy int32 arrays."""
        rng = np.random.default_rng(
            (self.spec.seed, step, self.process_index))
        b, s = self.local_batch, self.spec.seq_len
        u = rng.random((b, s + 1), dtype=np.float32)
        states = np.zeros((b, s + 1), np.int32)
        states[:, 0] = rng.integers(0, self.n_states, b)
        for t in range(1, s + 1):
            states[:, t] = np.argmax(
                u[:, t][:, None] < self.trans_cum[states[:, t - 1]], axis=1)
        tokens = self.proj[states]
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def batch(self, step: int) -> dict:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in self.batch_numpy(step).items()}
