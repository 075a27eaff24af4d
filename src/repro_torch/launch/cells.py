"""(architecture x input-shape) cell builders of the port.

The port of ``repro.launch.cells``.  ``build_cell(arch, shape, mesh)``
returns what a run of the cell needs, without allocating a parameter: the
step function, its arguments as tensors on the ``meta`` device (the
counterpart of ``jax.ShapeDtypeStruct``; parameter trees from each
family's ``init_params(..., device="meta")``), trees of
``dist.api.NamedSharding`` for the inputs and outputs, the activation
rules for ``dist.api.sharding_rules``, and the analytic model flops.  The
same formulas, specs and shapes as the JAX builders, which
``tests/test_torch_launch_cells.py`` holds them to.

Shape semantics (as the JAX module's):
  LM:     train_4k -> train_step; prefill_32k -> prefill;
          decode_32k / long_500k -> serve_step (1 new token vs. KV cache).
  GNN:    full-batch / sampled-block / batched-small train steps.
  RecSys: train_batch -> train_step; serve_* -> forward scoring;
          retrieval_cand -> query-tower + sharded MIPS top-k.

``mesh`` is a ``DeviceMesh`` with ``mesh_dim_names`` or a device-free
``dist.api.MeshShape``: the builders read axis names and sizes only (the
retrieval scorer reads ranks when it runs).  The train steps are the
port's: the recsys losses through the gather branch
(``train.step.ctr_loss_fn``, ``seqrec_loss_fn``) and EGNN's through its
per-edge-chunk checkpoints (``egnn_loss_fn``), whose values are the JAX
losses'.  A GNN cell's step takes the graph's ``egnn.GraphPlan`` as a
keyword (``fn(state, batch, plan=None)``: None builds it from the batch),
so a caller builds it once a graph, outside any fake or traced mode.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from repro_torch.configs import registry
from repro_torch.dist import sharding as shd
from repro_torch.dist.api import NamedSharding, P, axis_sizes, data_axes
from repro_torch.dist.retrieval import make_batched_scorer
from repro_torch.models import egnn as egnn_mod
from repro_torch.models import recsys as rs
from repro_torch.models import transformer as tf
from repro_torch.train import step as st
from repro_torch.train import tree
from repro_torch.train.optimizer import OPTIMIZERS, Optimizer

__all__ = ["LM_SHAPE_DEFS", "RECSYS_SHAPE_DEFS", "BuiltCell",
           "make_optimizer", "build_lm_cell", "build_gnn_cell",
           "build_recsys_cell", "build_cell"]

# ---------------------------------------------------------------- helpers

LM_SHAPE_DEFS = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="long", seq=524288, batch=1),
}
RECSYS_SHAPE_DEFS = registry.RECSYS_SHAPES


@dataclasses.dataclass
class BuiltCell:
    arch: str
    shape: str
    kind: str
    fn: Callable
    args: tuple
    in_shardings: Any
    out_shardings: Any
    rules: dict
    meta: dict


def make_optimizer(name: str) -> Optimizer:
    return OPTIMIZERS[name]()


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _named(mesh, spec_tree):
    return tree.map(lambda s: NamedSharding(mesh, s), spec_tree)


def _pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def _axis_prod(mesh, axes) -> int:
    sizes = axis_sizes(mesh)
    out = 1
    for a in axes:
        out *= sizes[a]
    return out


# ------------------------------------------------------------------- LM

def _lm_state(mod, cfg, mesh):
    opt = make_optimizer(mod.OPTIMIZER)
    params_shapes = tf.init_params(cfg, device="meta")
    opt_shapes = opt.init(params_shapes)
    p_specs = shd.param_specs(params_shapes, mesh)
    o_specs = opt.state_spec(params_shapes, p_specs)
    state_shapes = {"params": params_shapes, "opt": opt_shapes}
    state_specs = {"params": p_specs, "opt": o_specs}
    return opt, state_shapes, state_specs, params_shapes, p_specs


def _lm_flops(cfg, params_shapes, tokens: int, fwd_only: bool) -> float:
    n_active = tf.active_param_count(cfg, params_shapes)
    return (2 if fwd_only else 6) * n_active * tokens


def build_lm_cell(arch: str, shape: str, mesh,
                  cfg_override=None) -> BuiltCell:
    mod = registry.get(arch)
    cfg = cfg_override if cfg_override is not None else mod.full_config()
    d = LM_SHAPE_DEFS[shape]
    dp = tuple(data_axes(mesh))
    rules = shd.lm_activation_rules(mesh, cfg, d["kind"])
    opt, state_shapes, state_specs, params_shapes, p_specs = _lm_state(
        mod, cfg, mesh)
    b, s = d["batch"], d["seq"]

    if d["kind"] == "train":
        step = st.make_lm_train_step(cfg, opt,
                                     accum_steps=mod.TRAIN_ACCUM_STEPS,
                                     grad_shardings=_named(mesh, p_specs),
                                     accum_dtype=mod.ACCUM_DTYPE)
        batch_shapes = {"tokens": _sds((b, s), torch.int32),
                        "labels": _sds((b, s), torch.int32)}
        batch_specs = {"tokens": P(dp, None), "labels": P(dp, None)}
        return BuiltCell(
            arch, shape, "train", step,
            (state_shapes, batch_shapes),
            (_named(mesh, state_specs), _named(mesh, batch_specs)),
            (_named(mesh, state_specs), None), rules,
            {"model_flops": _lm_flops(cfg, params_shapes, b * s, False),
             "tokens": b * s})

    if d["kind"] == "prefill":
        def prefill(params, tokens):
            logits, _aux, _h, caches = tf.forward(
                params, tokens, cfg, return_kv=True, kv_len=s, remat="full")
            return logits, caches
        batch_shape = _sds((b, s), torch.int32)
        return BuiltCell(
            arch, shape, "prefill", prefill,
            (params_shapes, batch_shape),
            (_named(mesh, p_specs), NamedSharding(mesh, P(dp, None))),
            None, rules,
            {"model_flops": _lm_flops(cfg, params_shapes, b * s, True),
             "tokens": b * s})

    # decode / long: one new token against a KV cache of length `seq`
    caches_shapes = tf.init_kv_caches(cfg, b, s, device="meta")
    if cfg.attention == "mla":
        cache_spec_one = (P(*((None,) + tuple(rules["mla_cache"]))),
                          P(*((None,) + tuple(rules["mla_cache_r"]))))
    else:
        cache_spec_one = (P(*((None,) + tuple(rules["kv_cache"]))),) * 2
    caches_specs = [cache_spec_one for _ in cfg.layer_groups()]
    token_spec = P(dp) if b % max(1, _axis_prod(mesh, dp)) == 0 else P()

    def serve_step(params, token, caches, cur_len):
        return tf.decode_step(params, token, caches, cur_len, cfg)

    args = (params_shapes, _sds((b,), torch.int32), caches_shapes,
            _sds((), torch.int32))
    in_sh = (_named(mesh, p_specs), NamedSharding(mesh, token_spec),
             _named(mesh, caches_specs), NamedSharding(mesh, P()))
    out_sh = (None, _named(mesh, caches_specs))
    return BuiltCell(
        arch, shape, d["kind"], serve_step, args, in_sh, out_sh, rules,
        {"model_flops": _lm_flops(cfg, params_shapes, b, True),
         "tokens": b, "kv_len": s})


# ------------------------------------------------------------------- GNN

def build_gnn_cell(arch: str, shape: str, mesh) -> BuiltCell:
    mod = registry.get(arch)
    geom = mod.SHAPES[shape]
    dp = tuple(data_axes(mesh))
    every = dp + ("model",)
    n_dev = _axis_prod(mesh, every)
    # nodes sharded over the whole mesh too: the per-layer gather of h at
    # edge endpoints becomes the (realistic) all-gather collective of
    # distributed full-graph training.
    rules = {"edges": P(every, None), "nodes": P(every, None)}

    if geom["kind"] == "batched":
        n_nodes = geom["n_nodes"] * geom["batch"]
        n_edges = _pad_to(geom["n_edges"] * geom["batch"], n_dev)
        readout, n_out = "graph", geom["batch"]
        d_feat = geom["d_feat"]
    elif geom["kind"] == "mini":
        seeds = geom["batch_nodes"]
        f1, f2 = geom["fanout"]
        n_edges = _pad_to(seeds * f1 + seeds * f1 * f2, n_dev)
        n_nodes = _pad_to(seeds * (1 + f1 + f1 * f2), n_dev)
        readout, n_out = "node", n_nodes
        d_feat = geom["d_feat"]
    else:
        n_nodes = geom["n_nodes"]
        n_edges = _pad_to(geom["n_edges"], n_dev)
        readout, n_out = "node", n_nodes
        d_feat = geom["d_feat"]

    cfg = mod.full_config(d_feat=d_feat, readout=readout)
    opt = make_optimizer(mod.OPTIMIZER)
    params_shapes = egnn_mod.init_params(cfg, device="meta")
    opt_shapes = opt.init(params_shapes)
    p_specs = tree.map(lambda _: P(), params_shapes)   # tiny: replicate
    state_specs = {"params": p_specs,
                   "opt": opt.state_spec(params_shapes, p_specs)}
    n_graphs = geom.get("batch")

    def step(state, batch, plan=None):
        loss_fn = functools.partial(st.egnn_loss_fn, cfg=cfg,
                                    n_graphs=n_graphs, plan=plan)
        return st.make_train_step(loss_fn, opt)(state, batch)

    batch_shapes = {"feat": _sds((n_nodes, d_feat), torch.float32),
                    "coords": _sds((n_nodes, 3), torch.float32),
                    "edge_index": _sds((2, n_edges), torch.int32),
                    "labels": _sds((n_out,), torch.int32)}
    batch_specs = {"feat": P(None, None), "coords": P(None, None),
                   "edge_index": P(None, every), "labels": P(None)}
    if geom["kind"] == "batched":
        batch_shapes["graph_ids"] = _sds((n_nodes,), torch.int32)
        batch_specs["graph_ids"] = P(None)

    # message-passing flops: per edge per layer ~ 2 * (phi_e + phi_x) matmuls
    dh = cfg.d_hidden
    per_edge = 2 * ((2 * dh + 1) * dh + dh * dh + dh * dh + dh)
    per_node = 2 * (2 * dh * dh + dh * dh)
    mf = 3 * cfg.n_layers * (n_edges * per_edge + n_nodes * per_node)

    return BuiltCell(
        arch, shape, "train", step,
        ({"params": params_shapes, "opt": opt_shapes}, batch_shapes),
        (_named(mesh, state_specs), _named(mesh, batch_specs)),
        (_named(mesh, state_specs), None), rules,
        {"model_flops": float(mf), "edges": n_edges, "nodes": n_nodes})


# ---------------------------------------------------------------- RecSys

def _recsys_model(arch: str, cfg):
    if arch == "dlrm-rm2":
        init = functools.partial(rs.dlrm_init, cfg)
        fwd = functools.partial(rs.dlrm_forward, cfg=cfg)
    elif arch == "xdeepfm":
        init = functools.partial(rs.xdeepfm_init, cfg)
        fwd = functools.partial(rs.xdeepfm_forward, cfg=cfg)
    else:
        init = functools.partial(rs.seqrec_init, cfg)
        fwd = None
    return init, fwd


def _recsys_batch(arch: str, cfg, b: int) -> dict:
    if arch == "dlrm-rm2":
        return {"dense": _sds((b, cfg.n_dense), torch.float32),
                "sparse": _sds((b, cfg.n_sparse, cfg.multi_hot),
                               torch.int32),
                "label": _sds((b,), torch.float32)}
    if arch == "xdeepfm":
        return {"sparse": _sds((b, cfg.n_sparse, 1), torch.int32),
                "label": _sds((b,), torch.float32)}
    return {"items": _sds((b, cfg.max_len), torch.int32),
            "pos": _sds((b, cfg.max_len), torch.int32),
            "neg": _sds((b, cfg.max_len), torch.int32)}


def _recsys_flops(arch: str, cfg, b: int) -> float:
    if arch == "dlrm-rm2":
        mlp = sum(a * o for a, o in zip(cfg.bot_mlp[:-1], cfg.bot_mlp[1:]))
        top_in = cfg.embed_dim + 27 * 26 // 2
        tops = [top_in] + list(cfg.top_mlp_hidden)
        mlp += sum(a * o for a, o in zip(tops[:-1], tops[1:]))
        inter = 27 * 27 * cfg.embed_dim
        return 2.0 * b * (mlp + inter)
    if arch == "xdeepfm":
        m, dd = cfg.n_sparse, cfg.embed_dim
        cin = 0
        h_prev = m
        for h in cfg.cin_layers:
            cin += h_prev * m * dd + h * h_prev * m * dd
            h_prev = h
        dnn_sizes = [m * dd] + list(cfg.mlp) + [1]
        dnn = sum(a * o for a, o in zip(dnn_sizes[:-1], dnn_sizes[1:]))
        return 2.0 * b * (cin + dnn)
    d, s = cfg.embed_dim, cfg.max_len
    per_tok = 4 * d * d + 2 * cfg.d_ff_mult * d * d + 2 * s * d
    return 2.0 * b * s * cfg.n_blocks * per_tok


def build_recsys_cell(arch: str, shape: str, mesh) -> BuiltCell:
    mod = registry.get(arch)
    cfg = mod.full_config()
    d = RECSYS_SHAPE_DEFS[shape]
    dp = tuple(data_axes(mesh))
    every = dp + ("model",)
    rules = shd.lm_activation_rules(mesh, _DummyAttn(), "train")
    rules["act_bfd"] = P(dp, None, None)
    b = d["batch"]
    init, fwd = _recsys_model(arch, cfg)
    params_shapes = init(device="meta")
    p_specs = shd.param_specs(params_shapes, mesh)

    if d["kind"] == "train":
        opt = make_optimizer(mod.OPTIMIZER)
        opt_shapes = opt.init(params_shapes)
        state_specs = {"params": p_specs,
                       "opt": opt.state_spec(params_shapes, p_specs)}
        loss = (st.seqrec_loss_fn if arch in ("sasrec", "bert4rec")
                else st.ctr_loss_fn)
        step = st.make_train_step(functools.partial(loss, cfg=cfg), opt)
        batch_shapes = _recsys_batch(arch, cfg, b)
        batch_specs = tree.map(
            lambda s: P(*((dp,) + (None,) * (len(s.shape) - 1))),
            batch_shapes)
        return BuiltCell(
            arch, shape, "train", step,
            ({"params": params_shapes, "opt": opt_shapes}, batch_shapes),
            (_named(mesh, state_specs), _named(mesh, batch_specs)),
            (_named(mesh, state_specs), None), rules,
            {"model_flops": 3 * _recsys_flops(arch, cfg, b)})

    if d["kind"] == "serve":
        if arch in ("sasrec", "bert4rec"):
            scorer = make_batched_scorer(mesh, k=100, table_axes=("model",),
                                         batch_axes=dp)

            def serve(params, items):
                repr_ = rs.seqrec_session_repr(params, items, cfg)
                return scorer(repr_, params["item_emb"])
            batch_shapes = (_sds((b, cfg.max_len), torch.int32),)
            batch_specs = (P(dp, None),)
        else:
            bs = _recsys_batch(arch, cfg, b)
            bs.pop("label")
            batch_shapes = tuple(bs.values())
            batch_specs = tuple(
                P(*((dp,) + (None,) * (len(s.shape) - 1)))
                for s in batch_shapes)

            def serve(params, *args):
                return fwd(params, *args)
        return BuiltCell(
            arch, shape, "serve", serve,
            (params_shapes,) + tuple(batch_shapes),
            (_named(mesh, p_specs),) + tuple(
                NamedSharding(mesh, s) for s in batch_specs),
            None, rules,
            {"model_flops": _recsys_flops(arch, cfg, b)})

    # retrieval_cand: one query vs 1e6 candidates == the paper's index scan.
    # The full (shard-divisible, 2^20-row) item table is scored with rows
    # past n_candidates masked.
    n_cand = d["n_candidates"]
    scorer = make_batched_scorer(mesh, k=1000, table_axes=every,
                                 batch_axes=())
    if arch in ("sasrec", "bert4rec"):
        def retrieve(params, items):
            repr_ = rs.seqrec_session_repr(params, items, cfg)
            return scorer(repr_, params["item_emb"], n_valid=n_cand)
        batch_shapes = (_sds((b, cfg.max_len), torch.int32),)
    elif arch == "dlrm-rm2":
        def retrieve(params, dense, sparse):
            u = rs.dlrm_user_tower(params, dense, sparse, cfg)
            return scorer(u, params["tables"][0], n_valid=n_cand)
        batch_shapes = (_sds((b, cfg.n_dense), torch.float32),
                        _sds((b, cfg.n_sparse, cfg.multi_hot), torch.int32))
    else:
        def retrieve(params, sparse):
            u = rs.xdeepfm_user_tower(params, sparse, cfg)
            return scorer(u, params["tables"][0], n_valid=n_cand)
        batch_shapes = (_sds((b, cfg.n_sparse, 1), torch.int32),)
    batch_specs = tuple(P() for _ in batch_shapes)
    return BuiltCell(
        arch, shape, "retrieval", retrieve,
        (params_shapes,) + batch_shapes,
        (_named(mesh, p_specs),) + tuple(
            NamedSharding(mesh, s) for s in batch_specs),
        None, rules,
        {"model_flops": 2.0 * n_cand * cfg.embed_dim
         + _recsys_flops(arch, cfg, b)})


class _DummyAttn:
    n_heads = 1
    n_kv_heads = 1
    attention = "gqa"


# ----------------------------------------------------------------- entry

def build_cell(arch: str, shape: str, mesh) -> BuiltCell:
    fam = registry.get(arch).FAMILY
    builder = {"lm": build_lm_cell, "gnn": build_gnn_cell,
               "recsys": build_recsys_cell}[fam]
    return builder(arch, shape, mesh)
