"""Partition specs of parameters (``param_specs``) and activations
(``lm_activation_rules``, ``gnn_activation_rules``).

The port of ``repro.dist.sharding``: the same rules, in the same order.
``param_specs`` walks a parameter tree (of tensors, or anything with a
``shape``) and gives each leaf a full-rank ``P``:

  * name rules first: vocab and item tables are vocab-parallel (rows over
    ``"model"``), MoE expert stacks expert-parallel (experts over
    ``"model"``), the router replicated;
  * otherwise a shape heuristic: the larger of the last two dims goes to
    ``"model"``, the other to the data axes when it divides;
  * every assignment is checked to divide (``fit_spec``); a leaf smaller
    than ``min_shard_size`` elements is replicated.

A leaf's name is its key path (``train.tree``: dict keys, list indices,
``.field`` for a NamedTuple), as ``_key_names`` reads a JAX key path.
``place_tree`` lays a tree of tensors out as ``DTensor``s by its specs.
"""

from __future__ import annotations

from repro_torch.dist.api import (P, axis_sizes, data_axes, fit_spec,
                                  place)
from repro_torch.train import tree

__all__ = ["param_specs", "lm_activation_rules", "gnn_activation_rules",
           "replicated_specs", "place_tree"]


def _tp(mesh) -> int:
    return axis_sizes(mesh).get("model", 1)


def _dp_prod(mesh) -> int:
    sizes = axis_sizes(mesh)
    out = 1
    for a in data_axes(mesh):
        out *= sizes[a]
    return out


def _dp_entry(mesh):
    """The data axes as one spec entry: a name, a tuple, or None."""
    dp = data_axes(mesh)
    if not dp:
        return None
    return dp[0] if len(dp) == 1 else dp


def replicated_specs(t):
    """A tree of the same structure with fully replicated full-rank
    specs."""
    return tree.map(lambda leaf: P(*((None,) * len(leaf.shape))), t)


def param_specs(params_shapes, mesh, *, min_shard_size: int = 2 ** 14):
    """Full-rank specs for a parameter tree on ``mesh``.  A layer-stacked
    leaf keeps its stack dim unsharded."""
    tp = _tp(mesh)
    dp = _dp_entry(mesh)
    dp_prod = _dp_prod(mesh)

    def divides(dim: int, size: int) -> bool:
        return size > 0 and dim % size == 0

    def heuristic(shape) -> P:
        ndim = len(shape)
        spec = [None] * ndim
        if ndim >= 2:
            last, prev = ndim - 1, ndim - 2
            cands = [d for d in (last, prev)
                     if divides(shape[d], tp) and shape[d] >= 2 * tp]
            if cands:
                model_dim = max(cands, key=lambda d: (shape[d], d))
                spec[model_dim] = "model"
                other = prev if model_dim == last else last
                if dp is not None and divides(shape[other], dp_prod) \
                        and shape[other] >= 2 * dp_prod:
                    spec[other] = dp
        return P(*spec)

    def by_name(names, shape) -> P:
        leaf = names[-1] if names else ""
        ndim = len(shape)
        if leaf in ("embed", "item_emb") and ndim == 2:
            # vocab-parallel rows; a gathered table is never split by
            # feature
            return P("model" if divides(shape[0], tp) else None, None)
        if leaf == "lm_head" and ndim == 2:
            return P(None, "model" if divides(shape[1], tp) else None)
        if leaf in ("tables", "linear") and ndim == 3:
            # (fields, vocab, dim): the vocab rows over "model"
            return P(None, "model" if divides(shape[1], tp) else None, None)
        if leaf in ("wi", "wo") and any("moe" in n for n in names) \
                and ndim >= 3:
            # (stack?, experts, d, f): expert parallelism over "model"
            e_dim = ndim - 3
            if divides(shape[e_dim], tp):
                spec = [None] * ndim
                spec[e_dim] = "model"
                return P(*spec)
        if leaf == "router":
            return P(*((None,) * ndim))
        return heuristic(shape)

    def leaf_spec(path, leaf) -> P:
        shape = tuple(leaf.shape)
        size = 1
        for s in shape:
            size *= s
        if len(shape) == 0 or size < min_shard_size:
            return P(*((None,) * len(shape)))
        # every emitted assignment must divide
        return fit_spec(by_name(path, shape), shape, mesh)

    return tree.unflatten(params_shapes, [
        leaf_spec(p, leaf)
        for p, leaf in tree.leaves_with_path(params_shapes)])


def lm_activation_rules(mesh, cfg, kind: str = "train") -> dict:
    """Logical name -> spec for a transformer.  ``cfg`` needs ``n_heads``,
    ``n_kv_heads`` and ``vocab_size`` (a duck-typed stub will do); a
    decode-like ``kind`` ("decode", "long") whose KV heads do not divide
    ``"model"`` shards the cache's sequence axis instead."""
    tp = _tp(mesh)
    dp = _dp_entry(mesh)
    heads = "model" if getattr(cfg, "n_heads", 1) % tp == 0 else None
    kv = "model" if getattr(cfg, "n_kv_heads", 1) % tp == 0 else None
    vocab = getattr(cfg, "vocab_size", 0)
    logit = "model" if vocab and vocab % tp == 0 else None

    kv_cache = P(dp, None, kv, None)
    if kind in ("decode", "long") and kv is None:
        kv_cache = P(dp, "model", None, None)   # sequence-sharded cache

    return {
        "act_bsd": P(dp, None, None),
        "act_bsf": P(dp, None, "model"),
        "act_bfd": P(dp, None, None),
        "act_bshd": P(dp, None, heads, None),
        "act_bskd": P(dp, None, kv, None),
        "attn_scores": P(dp, heads, None, None),
        "kv_cache": kv_cache,
        "mla_cache": P(dp, None, None),
        "mla_cache_r": P(dp, None, None),
        "logits": P(dp, None, logit),
        "moe_buf": P("model", None, None),
        "moe_hidden": P("model", None, None),
        "moe_out": P(dp, None),
    }


def gnn_activation_rules(mesh) -> dict:
    """Edge and node tables over the whole mesh."""
    every = tuple(axis_sizes(mesh))
    return {"edges": P(every, None), "nodes": P(every, None)}


def place_tree(params, mesh, specs=None):
    """``params`` (the same global values on every rank) as ``DTensor``s
    laid out by ``specs`` (None: ``param_specs(params, mesh)``)."""
    specs = param_specs(params, mesh) if specs is None else specs
    return tree.map(lambda p, s: place(p, mesh, s), params, specs)
