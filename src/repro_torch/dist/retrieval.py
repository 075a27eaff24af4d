"""Host-callable index shards over device-resident corpus slices.

The port of ``repro.dist.retrieval``'s ``ShardTopK``, ``DeviceShard`` and
``make_device_shards`` (the device-mesh ``sharded_nn`` path is not part of
this port yet).  A ``DeviceShard`` is the callable ``ShardedRouter``
fronts: ``shard(queries, k) -> ShardTopK`` of numpy arrays, so hedging,
deadlines and degraded merges apply unchanged.  Its scan is the
``scan_topk`` contract; on a CUDA device that is the fused kNN kernels.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import layout, quant
from repro_torch.core.cache_ops import pad_features
from repro_torch.core.metric_index import scan_topk
from repro_torch.kernels.dispatch import resolve_device

__all__ = ["ShardTopK", "DeviceShard", "make_device_shards"]


class ShardTopK(NamedTuple):
    """Host-side per-shard answer (duck-compatible with ``ShardAnswer``)."""
    scores: np.ndarray     # (B, k)
    ids: np.ndarray        # (B, k) global doc ids, -1 past the shard's corpus


class DeviceShard:
    """A corpus slice pinned to one device.

    ``docs`` (n, d) transformed embeddings, stored at the padded width
    ``layout.phys_dim(d)`` in ``dtype`` (None follows ``REPRO_CORPUS_DTYPE``)
    and quantized once here.  An f32 tensor that already lies on the device
    at a padded width is used as is, without a copy, so a serving process
    can share one corpus allocation between the shard and the engine's
    document lookups.
    """

    def __init__(self, docs, doc_ids, device=None, dtype: Optional[str] = None,
                 int8_dot: Optional[bool] = None):
        self.device = resolve_device(device)
        docs = torch.as_tensor(docs, device=self.device).to(torch.float32)
        self.doc_ids = torch.as_tensor(doc_ids, device=self.device) \
            .to(torch.int32)
        docs = pad_features(docs, layout.phys_dim(docs.shape[1]))
        self.dtype = quant.resolve_dtype(dtype)
        qc = quant.quantize(docs, self.dtype)
        self.docs, self.scale = qc.data, qc.scale
        self.int8_dot = quant.resolve_int8_dot(int8_dot, self.docs.dtype)
        self.n_docs = int(docs.shape[0])

    def __call__(self, queries, k: int) -> ShardTopK:
        q = torch.as_tensor(np.asarray(queries, np.float32),
                            device=self.device)
        if q.ndim == 1:
            q = q[None]
        scores, ids = scan_topk(self.docs, self.doc_ids, q, int(k),
                                scale=self.scale, int8_dot=self.int8_dot)
        return ShardTopK(scores.cpu().numpy(), ids.cpu().numpy())


def make_device_shards(docs, doc_ids=None, *, devices=None,
                       dtype: Optional[str] = None) -> list:
    """One ``DeviceShard`` per device over equal contiguous slices (every
    visible CUDA device by default)."""
    if devices is None:
        resolve_device(None)
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    docs = torch.as_tensor(docs)
    n = docs.shape[0]
    if doc_ids is None:
        doc_ids = torch.arange(n, dtype=torch.int32)
    per = -(-n // len(devices))
    return [DeviceShard(docs[lo:lo + per], doc_ids[lo:lo + per], device=dev,
                        dtype=dtype)
            for dev, lo in zip(devices, range(0, n, per))]
