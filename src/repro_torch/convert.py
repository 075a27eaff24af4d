"""Carry state across from the JAX package (and back, for comparisons).

The system has no model weights: its state is the corpus and the cache.
Both packages exchange it as numpy arrays.

  * ``cache_state_from_numpy`` — a JAX ``CacheState`` (any object with the
    same fields, or a mapping) as numpy arrays at the JAX physical extents:
    sliced to the logical extents of ``cfg`` and re-padded to this port's
    layout with the empty-slot sentinels.
  * ``cache_state_to_numpy`` — any ``CacheState`` (this port's or the JAX
    package's) at the logical extents, bf16 payloads widened to f32 — the
    form two states are compared in.
  * ``shared_tier_to_numpy`` / ``shared_tier_from_numpy`` — a
    ``SharedTier``'s whole state (the stacked shard cache at logical
    extents, the wave clock, claim stamps, admission table, pending
    admissions, result memo and counters) out of either package's tier,
    and into this port's, so both tiers continue alike.
  * ``corpus_from_numpy`` — a (quantized) corpus payload with its scales and
    ids, padded to this port's feature width, on a device.
  * ``recsys_params_from_numpy`` / ``recsys_params_to_numpy`` — a DLRM or
    xDeepFM parameter tree (nested dicts and lists of arrays, the JAX
    package's layout: MLP weights (in, out), tables (F, V, D)) carried to
    this port's tensors and back, so both packages compute the same logits.
  * ``transformer_params_from_numpy`` / ``transformer_params_to_numpy`` — a
    ``models.transformer`` parameter tree (``embed``, ``final_norm``,
    ``lm_head``, the stacked ``group{i}_{kind}`` layers; weights (d_in,
    d_out)) carried across and back, bf16 leaves included; a bare array
    (the query encoder's ``proj``) goes through the same calls; MoE
    (``ffn/{router,wi,wo,shared_wi,shared_wo}``), MLA and MTP trees
    included.
  * ``seqrec_params_from_numpy`` / ``seqrec_params_to_numpy`` — a SASRec /
    BERT4Rec tree (``item_emb``, ``pos_emb``, ``final_norm`` and the list
    of block dicts with their ``ffn`` layer lists) carried across and back;
    f32 throughout, so the round trip is exact.
  * ``egnn_params_from_numpy`` / ``egnn_params_to_numpy`` — an EGNN tree
    (``encoder``, ``head`` and the list of layer dicts of ``phi_e`` /
    ``phi_x`` / ``phi_h`` MLPs) carried across and back, exactly.
  * ``kv_caches_from_numpy`` / ``kv_caches_to_numpy`` — the per-group list
    of cache tuples that ``init_kv_caches`` and ``forward(return_kv=True)``
    return ((k, v), or (c_kv, k_rope) for MLA; each (count, B, S, ...)),
    carried across and back.
  * ``opt_state_from_numpy`` / ``opt_state_to_numpy`` — an optimizer
    state (the JAX package's ``OptState`` or any object with ``step`` and
    ``inner``): AdamW's ``m`` / ``v`` or Adafactor's ``v`` tree of
    ``{"vr", "vc"}`` / ``{"v"}`` in the params' structure, f32, the step
    an int32 scalar; carried across and back exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import layout
from repro_torch.core.cache_ops import (CacheConfig, CacheState,
                                        init_batched_cache, pad_features,
                                        to_numpy)
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.train.optimizer import OptState

__all__ = ["cache_state_from_numpy", "cache_state_to_numpy",
           "shared_tier_to_numpy", "shared_tier_from_numpy",
           "corpus_from_numpy", "recsys_params_from_numpy",
           "recsys_params_to_numpy", "transformer_params_from_numpy",
           "transformer_params_to_numpy", "seqrec_params_from_numpy",
           "seqrec_params_to_numpy", "egnn_params_from_numpy",
           "egnn_params_to_numpy", "kv_caches_from_numpy",
           "kv_caches_to_numpy", "opt_state_from_numpy",
           "opt_state_to_numpy"]


def _fields(leaves) -> dict:
    if isinstance(leaves, dict):
        return {f: leaves[f] for f in CacheState._fields}
    return {f: getattr(leaves, f) for f in CacheState._fields}


def cache_state_to_numpy(state, cfg: CacheConfig) -> CacheState:
    """The state at logical extents as numpy arrays."""
    c, d, q = cfg.capacity, cfg.dim, cfg.max_queries
    a = {f: to_numpy(v) for f, v in _fields(state).items()}
    return CacheState(
        doc_emb=a["doc_emb"][..., :c, :d], doc_ids=a["doc_ids"][..., :c],
        doc_stamp=a["doc_stamp"][..., :c], q_emb=a["q_emb"][..., :q, :d],
        q_radius=a["q_radius"][..., :q], n_docs=a["n_docs"],
        n_queries=a["n_queries"], step=a["step"],
        doc_scale=a["doc_scale"][..., :c], q_scale=a["q_scale"][..., :q])


def cache_state_from_numpy(leaves, cfg: CacheConfig, device=None) -> CacheState:
    """A (batched or unbatched) state at this port's physical extents whose
    logical content equals ``leaves``'."""
    logical = cache_state_to_numpy(leaves, cfg)
    batched = np.ndim(logical.n_docs) > 0
    if not batched:
        logical = CacheState(*(x[None] for x in logical))
    state = init_batched_cache(cfg, logical.n_docs.shape[0], device)
    c, d, q = cfg.capacity, cfg.dim, cfg.max_queries
    dev = state.doc_ids.device

    def put(dst, src):
        dst.copy_(torch.as_tensor(np.array(src), device=dev)
                  .to(dst.dtype))

    put(state.doc_emb[:, :c, :d], logical.doc_emb)
    put(state.q_emb[:, :q, :d], logical.q_emb)
    for f in ("doc_ids", "doc_stamp", "doc_scale"):
        put(getattr(state, f)[:, :c], getattr(logical, f))
    for f in ("q_radius", "q_scale"):
        put(getattr(state, f)[:, :q], getattr(logical, f))
    for f in ("n_docs", "n_queries", "step"):
        put(getattr(state, f), getattr(logical, f))
    return state if batched else CacheState(*(x[0] for x in state))


_TIER_HOST = ("wave", "_seen", "_memo_radius", "_memo_token", "_memo_wave",
              "_memo_n", "n_promoted", "n_offered", "n_memo_served",
              "n_stale_served", "total_dropped")
_TIER_MEMO = ("_memo_psi", "_memo_ids", "_memo_scores")


def shared_tier_to_numpy(tier) -> dict:
    """A ``SharedTier``'s state (this port's or the JAX package's) as numpy
    arrays and plain values; claim stamps at the logical ring length."""
    import copy
    q = tier.cfg.max_queries
    out = {"state": cache_state_to_numpy(tier.state, tier.cfg),
           "claim_wave": np.array(tier._claim_wave[:, :q]),
           "claim_alive": np.array(tier._claim_alive[:, :q]),
           "pending": [(p[0], np.array(p[1]), p[2], to_numpy(p[3]),
                        np.array(p[4])) for p in tier._pending]}
    for f in _TIER_HOST:
        out[f] = copy.deepcopy(getattr(tier, f))
    for f in _TIER_MEMO:
        v = getattr(tier, f)
        out[f] = None if v is None else np.array(v)
    return out


def shared_tier_from_numpy(tier, leaves: dict):
    """Load ``shared_tier_to_numpy``'s output into this port's ``tier`` (same
    configuration), in place; returns the tier."""
    import copy
    q = tier.cfg.max_queries
    tier.state = cache_state_from_numpy(leaves["state"], tier.cfg,
                                        tier.device)
    tier._claim_wave[:, :q] = leaves["claim_wave"]
    tier._claim_alive[:, :q] = leaves["claim_alive"]
    tier._pending = [(int(p[0]), np.array(p[1]), float(p[2]),
                      torch.as_tensor(np.array(p[3]), device=tier.device),
                      np.array(p[4])) for p in leaves["pending"]]
    for f in _TIER_HOST:
        setattr(tier, f, copy.deepcopy(leaves[f]))
    for f in _TIER_MEMO:
        v = leaves[f]
        setattr(tier, f, None if v is None else np.array(v))
    return tier


def _tensor(a, dev) -> torch.Tensor:
    """An array numpy can read as a tensor on ``dev``; a numpy bfloat16
    array (the JAX package's bf16) arrives as torch.bfloat16."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.as_tensor(a.astype(np.float32), device=dev) \
            .to(torch.bfloat16)
    return torch.as_tensor(np.array(a), device=dev)


def corpus_from_numpy(data, scale, ids, device=None):
    """(docs (N, phys_dim(D)) in the payload's dtype, scale (N,) f32 or
    None, ids (N,) int32) on ``device``.  A bf16 payload arrives as the
    numpy bfloat16 array the JAX package hands out."""
    dev = resolve_device(device)
    docs = _tensor(data, dev)
    docs = pad_features(docs, layout.phys_dim(docs.shape[1]))
    sc = None if scale is None else torch.as_tensor(
        np.asarray(scale, np.float32), device=dev)
    return docs, sc, torch.as_tensor(np.asarray(ids, np.int32), device=dev)


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


def recsys_params_from_numpy(params, device=None) -> dict:
    """The JAX package's DLRM / xDeepFM parameter tree (arrays of any kind
    numpy can read) as this port's tensors on ``device``."""
    dev = resolve_device(device)
    return _map_tree(lambda a: _tensor(a, dev), params)


def recsys_params_to_numpy(params) -> dict:
    """A parameter tree of tensors (``DLRM(...).params`` or the functions'
    dicts) as numpy arrays in the JAX package's layout."""
    return _map_tree(to_numpy, params)


def transformer_params_from_numpy(params, device=None):
    """The JAX package's transformer parameter tree (or one array, e.g. the
    encoder's ``proj``) as this port's tensors on ``device``: the same
    nested dicts, stacked leaves and orientation."""
    dev = resolve_device(device)
    return _map_tree(lambda a: _tensor(a, dev), params)


def transformer_params_to_numpy(params):
    """A transformer tree of tensors (or one tensor) as numpy arrays in the
    JAX package's layout; bf16 widened to f32 (exact)."""
    return _map_tree(to_numpy, params)


def seqrec_params_from_numpy(params, device=None) -> dict:
    """The JAX package's SASRec / BERT4Rec parameter tree as this port's
    tensors on ``device``: the same dicts and lists, weights (d_in,
    d_out)."""
    dev = resolve_device(device)
    return _map_tree(lambda a: _tensor(a, dev), params)


def seqrec_params_to_numpy(params) -> dict:
    """A seqrec tree of tensors (``SeqRec(...).params`` or the functions'
    dicts) as numpy arrays in the JAX package's layout."""
    return _map_tree(to_numpy, params)


def egnn_params_from_numpy(params, device=None) -> dict:
    """The JAX package's EGNN parameter tree as this port's tensors on
    ``device``."""
    dev = resolve_device(device)
    return _map_tree(lambda a: _tensor(a, dev), params)


def egnn_params_to_numpy(params) -> dict:
    """An EGNN tree of tensors as numpy arrays in the JAX package's
    layout."""
    return _map_tree(to_numpy, params)


def kv_caches_from_numpy(caches, device=None) -> list:
    """The JAX package's decode caches (a list, one tuple of arrays per
    layer group) as this port's: a list of tuples of tensors on
    ``device``, bf16 kept."""
    dev = resolve_device(device)
    return [tuple(_tensor(c, dev) for c in group) for group in caches]


def kv_caches_to_numpy(caches) -> list:
    """Decode caches of either package as a list of tuples of numpy
    arrays; bf16 widened to f32 (exact)."""
    return [tuple(to_numpy(c) for c in group) for group in caches]


def opt_state_from_numpy(state, device=None):
    """An optimizer state of either package (``step``, ``inner``) as this
    port's ``OptState`` on ``device``."""
    dev = resolve_device(device)
    step = _tensor(np.asarray(state.step, np.int32), dev)
    return OptState(step, _map_tree(lambda a: _tensor(a, dev), state.inner))


def opt_state_to_numpy(state):
    """An optimizer state of either package as an ``OptState`` of numpy
    arrays (the step an int32 scalar)."""
    return OptState(np.asarray(to_numpy(state.step), np.int32),
                    _map_tree(to_numpy, state.inner))
