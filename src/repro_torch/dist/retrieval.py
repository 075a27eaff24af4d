"""The distributed back-end index: the sharded dense index of Fig. 2.

The port of ``repro.dist.retrieval``.  Three layers, smallest deployment
to largest:

  * ``make_batched_scorer``: table-sharded top-k MIPS for the serving
    cells (recsys ``retrieval_cand``): queries split over the batch axes,
    table rows over the table axes; each rank scores and selects its block
    through ``scan_topk`` (the kNN kernels on the card), then the partial
    answers are all-gathered and merged.
  * ``shard_corpus`` / ``sharded_nn``: exact k-NN with the corpus split
    in equal contiguous row slices over a ``DeviceMesh``.  Every rank runs
    ``scan_topk``, the same scan a single-device search runs, over its
    slice, the (B, k) partials are all-gathered in rank order (row order)
    and merged by a stable sort, so the ranking equals ``exact_nn``'s.
  * ``DeviceShard`` / ``make_device_shards``: host-callable shard handles
    over device-resident slices, the callables ``ShardedRouter`` fronts
    (``shard(queries, k) -> ShardTopK`` of numpy arrays), so hedging,
    deadlines and degraded merges apply unchanged.

Every function of the first two layers is called by every rank (SPMD) and
returns the same answer on each.  A corpus or table is a ``DTensor`` on
the mesh, or a plain tensor holding the same global value on every rank.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import layout, quant
from repro_torch.core.cache_ops import pad_features
from repro_torch.core.metric_index import SearchResult, _as_result, scan_topk
from repro_torch.dist.api import active_mesh, axis_sizes, mesh_device
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.serve.telemetry import SPANS, sync_site

_SCAN = SPANS.kind("serve.scan")
_SHARD_QUERIES = sync_site("shard_queries")
_SHARD_SCORES = sync_site("shard_scores")
_SHARD_IDS = sync_site("shard_ids")

__all__ = ["make_batched_scorer", "sharded_nn", "shard_corpus", "ShardTopK",
           "DeviceShard", "make_device_shards"]


# ------------------------------------------------------- batched scoring

def _dtensor():
    from torch.distributed.tensor import DTensor
    return DTensor


def _placements(mesh, dims: dict) -> list:
    """Placements with ``Shard(d)`` on each mesh axis named in ``dims``
    ({axis: tensor dim}), ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(dims[a]) if a in dims else Replicate()
            for a in axis_sizes(mesh)]


def _block(mesh, axes: Sequence[str]) -> tuple:
    """(this rank's block index, block count) along ``axes``, the first
    the major one: the order in which DTensor splits a dim over them."""
    sizes = axis_sizes(mesh)
    idx, count = 0, 1
    for a in axes:
        idx = idx * sizes[a] + mesh.get_local_rank(a)
        count *= sizes[a]
    return idx, count


def _local_rows(x, mesh, axes: Sequence[str]) -> torch.Tensor:
    """This rank's contiguous block of rows of ``x`` (a global tensor, or a
    ``DTensor`` redistributed to rows over ``axes``)."""
    if isinstance(x, _dtensor()):
        return x.redistribute(mesh, _placements(
            mesh, {a: 0 for a in axes})).to_local()
    idx, count = _block(mesh, axes)
    per = -(-x.shape[0] // count)
    return x[idx * per:(idx + 1) * per]


def _gather_merge(vals: torch.Tensor, ids: torch.Tensor, mesh,
                  cand_axes: Sequence[str], row_axes: Sequence[str],
                  k: int, rows: int):
    """All-gather the (B_loc, k_loc) partials of every rank, candidates
    over ``cand_axes`` (in block order, which is row order) and the
    ``rows`` query rows over ``row_axes``, then keep the stable top ``k``
    of each row: among equal scores the lower row of the corpus wins, as
    in ``exact_nn``."""
    DTensor = _dtensor()
    dims = {a: 0 for a in row_axes}
    dims.update({a: 1 for a in cand_axes})
    pl = _placements(mesh, dims)
    shape = torch.Size((rows, vals.shape[1] * _block(mesh, cand_axes)[1]))

    def gather(t):
        return DTensor.from_local(t, mesh, pl, run_check=False, shape=shape,
                                  stride=(shape[1], 1)).full_tensor()

    all_s, all_i = gather(vals), gather(ids)
    top_s, pos = torch.sort(all_s, dim=1, descending=True, stable=True)
    return top_s[:, :k], torch.gather(all_i, 1, pos[:, :k])


def make_batched_scorer(mesh, k: int, table_axes: Sequence[str] = ("model",),
                        batch_axes: Sequence[str] = ()):
    """``scorer(queries, table, n_valid=None) -> (scores, ids)``.

    ``queries`` (B, D) split their rows over ``batch_axes``, ``table``
    (V, D) its rows over ``table_axes``.  Each rank scores and selects its
    block through ``scan_topk`` (the kNN kernels on the card; a block
    narrower than the kernels' feature tile zero-padded to it, a copy),
    rows at or past ``n_valid`` masked (an uneven candidate set in a
    divisible table), then the partials are all-gathered and merged.  Returns plain
    (B, min(k, V)) tensors, the same on every rank; ids are row positions
    in ``table``.
    """
    t_axes, b_axes = tuple(table_axes), tuple(batch_axes)

    def scorer(queries, table, n_valid: Optional[int] = None):
        kk = min(k, table.shape[0])
        q = _local_rows(queries, mesh, b_axes).to(torch.float32)
        # the kNN kernels' feature tile: a narrow table (SASRec's 50,
        # xDeepFM's 10) is scored zero-padded, as candidate_index holds it
        t = _local_rows(table, mesh, t_axes)
        t = pad_features(t, layout.phys_dim(t.shape[1]))
        idx, count = _block(mesh, t_axes)
        r0 = idx * (-(-table.shape[0] // count))
        ids = torch.arange(r0, r0 + t.shape[0], dtype=torch.int32,
                           device=t.device)
        if n_valid is not None:
            ids = torch.where(ids < n_valid, ids, -1)
        vals, got = scan_topk(t, ids, q, kk)
        return _gather_merge(vals, got, mesh, t_axes, b_axes, kk,
                             queries.shape[0])

    return scorer


# ----------------------------------------------------- sharded exact k-NN

_FLAT: dict = {}


def _flat_mesh():
    """A one-axis mesh ``("shard",)`` over every rank of the default
    group (on the card under NCCL), made once a group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("sharded_nn needs a process group: call "
                           "torch.distributed.init_process_group first")
    key = id(dist.group.WORLD)
    if key not in _FLAT:
        dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
        _FLAT[key] = init_device_mesh(dev, (dist.get_world_size(),),
                                      mesh_dim_names=("shard",))
    return _FLAT[key]


def _resolve(mesh, axes: Optional[Sequence[str]]):
    mesh = mesh if mesh is not None else (active_mesh() or _flat_mesh())
    axes = tuple(axes) if axes is not None else tuple(axis_sizes(mesh))
    return mesh, axes


def shard_corpus(docs, doc_ids, *, scale=None, mesh=None,
                 axes: Optional[Sequence[str]] = None, chunk: int = 4096):
    """Pad a corpus to equal slices and lay it out over ``mesh``.

    ``docs`` (n, Dp) (an f32 corpus, or a bf16 / int8 payload with
    ``scale`` its (n,) f32 per-document multiplier), ``doc_ids`` (n,).
    The rows are padded to ``n_dev * ceil(n / n_dev)`` with zero rows of
    id -1 (which never win) and scale 1.  Returns (docs, doc_ids, scale,
    mesh, chunk) with the first three ``DTensor``s split by rows over
    ``axes`` (every mesh axis by default): each rank holds its own slice.
    At a world of one, a corpus already on the mesh's device is used as
    it is, without a copy.  ``chunk`` is the JAX signature's scan chunk;
    the port's scan has none, and ``min(chunk, rows per slice)`` comes
    back unused.
    """
    DTensor = _dtensor()
    mesh, axes = _resolve(mesh, axes)
    dev = mesh_device(mesh)
    docs = torch.as_tensor(docs, device=dev)
    doc_ids = torch.as_tensor(doc_ids, device=dev).to(torch.int32)
    if scale is not None:
        scale = torch.as_tensor(scale, device=dev)
    n = docs.shape[0]
    idx, count = _block(mesh, axes)
    per = -(-n // count)
    lo, hi = min(idx * per, n), min((idx + 1) * per, n)
    short = per - (hi - lo)

    def local(t, fill):
        part = t[lo:hi]
        if count == 1:
            return part                  # the whole corpus: no copy
        if short:
            pad = torch.full((short,) + tuple(t.shape[1:]), fill,
                             dtype=t.dtype, device=t.device)
            return torch.cat([part, pad])
        return part.clone()              # its own slice, not a view

    pl = _placements(mesh, {a: 0 for a in axes})

    def lay(t, fill):
        shape = (per * count,) + tuple(t.shape[1:])
        return DTensor.from_local(local(t, fill), mesh, pl, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=torch.empty(shape, device="meta")
                                  .stride())

    out_scale = None if scale is None else lay(scale, 1)
    return lay(docs, 0), lay(doc_ids, -1), out_scale, mesh, min(chunk, per)


def sharded_nn(docs, doc_ids, queries, k: int, *, mesh=None,
               axes: Optional[Sequence[str]] = None, chunk: int = 4096,
               scale=None, int8_dot: Optional[bool] = None) -> SearchResult:
    """Exact k-NN with the corpus split over ``mesh`` (its ``axes``: every
    axis by default); every rank calls it and gets the same answer.

    ``mesh`` None is the active ``sharding_rules`` mesh, else a flat mesh
    over the default process group; with no process group it raises.  A
    corpus laid out by ``shard_corpus`` (``DTensor``s) is searched as it
    lies; a plain one is laid out first.  Each rank runs ``scan_topk``
    over its slice (the ``knn_score`` and ``knn_select`` kernels on the
    card), the (B, k) partials are all-gathered in row order and merged
    with a stable sort.  ``int8_dot`` (None: the ``REPRO_INT8_DOT``
    policy) is resolved here, so every slice scores alike.  At fp32 the
    ranking equals ``exact_nn``'s on the unpadded corpus.
    """
    if not isinstance(docs, _dtensor()):
        docs, doc_ids, scale, mesh, _ = shard_corpus(
            docs, doc_ids, scale=scale, mesh=mesh, axes=axes, chunk=chunk)
    mesh = docs.device_mesh
    axes = tuple(a for a, p in zip(axis_sizes(mesh), docs.placements)
                 if p.is_shard())
    q = torch.as_tensor(queries, dtype=torch.float32,
                        device=mesh_device(mesh))
    if q.ndim == 1:
        q = q[None]
    k = int(min(k, docs.shape[0]))
    loc = docs.to_local()
    vals, ids = scan_topk(loc, doc_ids.to_local(), q, k,
                          scale=None if scale is None else scale.to_local(),
                          int8_dot=quant.resolve_int8_dot(int8_dot,
                                                          loc.dtype))
    return _as_result(*_gather_merge(vals, ids, mesh, axes, (), k,
                                     q.shape[0]))


# ------------------------------------------------- host-side shard handles

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
        with _SCAN:
            q = _SHARD_QUERIES.device(np.asarray(queries, np.float32),
                                      self.device)
            if q.ndim == 1:
                q = q[None]
            scores, ids = scan_topk(self.docs, self.doc_ids, q, int(k),
                                    scale=self.scale, int8_dot=self.int8_dot)
            return ShardTopK(_SHARD_SCORES.host(scores),
                             _SHARD_IDS.host(ids))


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
