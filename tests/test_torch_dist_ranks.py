"""The rank side of the port's distributed tests, and the launcher's own
tests.

``repro_torch.launch.hostdevices.run_ranks`` spawns one process a rank,
and each imports the module of the function it runs.  This module imports
torch, numpy and the port only (no JAX), so a rank starts in about the
time torch takes to import; ``test_torch_dist.py`` and
``test_torch_dist_moe.py`` run these bodies over 1, 2, 4 and 8 gloo ranks
and hold rank 0's numpy results against the JAX package in the pytest
process.  Inputs are made here from seeds with numpy, so both sides build
them alike (``corpus``, ``moe_inputs``, ``lm_batch``).

The launcher: rank 0's value comes back; an exception in any rank is
raised in the caller with that rank's traceback; a world that hangs is
killed at its timeout.
"""

import os
import time

import numpy as np
import pytest
import torch

from repro_torch.launch.hostdevices import run_ranks

STAR_SEQ = 16


# ------------------------------------------------------------- inputs

def corpus(n, dim, seed=0, n_dup=0, n_queries=5):
    """Raw document and query embeddings; the first ``n_dup`` documents
    are repeated mid-corpus so that ties are broken by position."""
    rng = np.random.default_rng(seed)
    phi = rng.standard_normal((n, dim)).astype(np.float32)
    if n_dup:
        phi[n // 2:n // 2 + n_dup] = phi[:n_dup]
    return phi, rng.standard_normal((n_queries, dim)).astype(np.float32)


def scorer_inputs():
    rng = np.random.default_rng(11)
    return (rng.standard_normal((512, 64)).astype(np.float32),
            rng.standard_normal((8, 64)).astype(np.float32))


def moe_inputs(t=64, d=32):
    """(x (T, d), w (T, d)): the tokens and the loss weights."""
    rng = np.random.default_rng(3)
    return (rng.standard_normal((t, d)).astype(np.float32),
            rng.standard_normal((t, d)).astype(np.float32))


def lm_batch(vocab, b=4, s=STAR_SEQ, seed=1):
    """Next-token rows with every label live: each microbatch then holds
    as many labels as any other, so the mean of the microbatches' mean
    losses is the whole batch's, and so are its gradients (the sign
    reference of ``train.parity``)."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (b, s)).astype(np.int32)
    return {"tokens": tok, "labels": np.roll(tok, -1, 1)}


# ------------------------------------------------------------- helpers

def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def _gather(obj):
    """Every rank's ``obj``, in rank order."""
    import torch.distributed as dist
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _names(placements):
    """Placements as (kind, dim) pairs: ("Shard", 0), ("Replicate", None)."""
    return [(type(p).__name__, getattr(p, "dim", None)) for p in placements]


def _np(t):
    from repro_torch.dist.api import is_dtensor
    if is_dtensor(t):
        t = t.full_tensor()
    return t.detach().cpu().numpy()


# --------------------------------------------------- world 8: dist.api

def api_world8(rank, world):
    """``constrain`` and ``to_placements`` on (2, 4) and (2, 2, 2)
    meshes: the local blocks every rank holds."""
    from repro_torch.dist.api import (P, active_mesh, constrain, place,
                                      sharding_rules)
    out = {}
    mesh = _mesh((2, 4), ("data", "model"))
    x = torch.arange(4 * 8 * 16, dtype=torch.float32).reshape(4, 8, 16)
    odd = torch.ones(3, 8, 6)
    with sharding_rules(mesh, {"act_bsd": P("data", None, "model")}):
        out["active_inside"] = active_mesh() is mesh
        y = constrain(place(x, mesh, P()), "act_bsd")
        z = constrain(place(odd, mesh, P()), "act_bsd")
        w = torch.zeros(5)
        plain = torch.zeros(4, 8, 16)
        out["identity"] = (constrain(w, "no_such_rule") is w
                           and constrain(plain, "act_bsd") is plain)
        out["y_blocks"] = _gather(y.to_local().numpy())
        out["y_full"] = _np(y)
        out["z_shape"] = tuple(z.shape)
        out["z_local"] = tuple(z.to_local().shape)
    out["active_after"] = active_mesh() is None
    t = torch.arange(16 * 6, dtype=torch.float32).reshape(16, 6)
    out["tuple_blocks"] = _gather(
        place(t, mesh, P(("data", "model"), None)).to_local().numpy())
    out["two_dim_blocks"] = _gather(
        place(t[:8, :4], mesh, P("model", "data")).to_local().numpy())
    cube = _mesh((2, 2, 2), ("pod", "data", "model"))
    out["cube_blocks"] = _gather(place(t, cube, P(("pod", "data"), "model"))
                                 .to_local().numpy())
    return out


# --------------------------------------------- world 8: dist.retrieval

def retrieval_world8(rank, world):
    from repro_torch.core import embedding as emb
    from repro_torch.core.metric_index import MetricIndex, exact_nn
    from repro_torch.dist import retrieval as dr
    from repro_torch.kernels import dispatch
    out = {}
    meshes = {"flat": None, "shard8": _mesh((8,), ("shard",)),
              "data2_model4": _mesh((2, 4), ("data", "model"))}
    for n in (4096, 5003):
        phi, q = corpus(n, 32, n_dup=16)
        docs, _ = emb.transform_documents(torch.as_tensor(phi))
        qq = emb.transform_queries(torch.as_tensor(q))
        ids = torch.arange(n, dtype=torch.int32)
        ref = exact_nn(docs, ids, qq, 25)
        out[(n, "exact")] = (_np(ref.ids), _np(ref.scores))
        for name, mesh in meshes.items():
            r = dr.sharded_nn(docs, ids, qq, 25, mesh=mesh, chunk=512)
            out[(n, name)] = (_np(r.ids), _np(r.scores), _np(r.distances))
    phi, q = corpus(300, 16, seed=3)
    docs, _ = emb.transform_documents(torch.as_tensor(phi))
    qq = emb.transform_queries(torch.as_tensor(q))
    ids = torch.arange(300, dtype=torch.int32)
    dispatch.reset_counters()
    out["k120"] = _np(dr.sharded_nn(docs, ids, qq, 120, chunk=64).ids)
    out["k120_calls"] = dispatch.counter("knn_score").calls
    out["k120_exact"] = _np(exact_nn(docs, ids, qq, 120).ids)

    rng = np.random.default_rng(7)
    raw = rng.standard_normal((3000, 48)).astype(np.float32)
    q = rng.standard_normal((4, 48)).astype(np.float32)
    local = MetricIndex(raw, device="cpu")
    qq = local.transform_queries(torch.as_tensor(q))
    out["mi_local"] = _np(local.search(qq, 30).ids)
    for dtype in ("fp32", "bf16", "int8"):
        shard = MetricIndex(raw, device="cpu", sharded=True, dtype=dtype)
        out[("mi", dtype)] = _np(shard.search(qq, 30).ids)
        out[("mi_local", dtype)] = _np(
            MetricIndex(raw, device="cpu", dtype=dtype).search(qq, 30).ids)
        out[("mi_rows", dtype)] = tuple(shard.doc_emb.to_local().shape)
    out["mi_1d"] = tuple(shard.search(qq[0], 10).ids.shape)

    table, q = scorer_inputs()
    mesh = meshes["data2_model4"]
    scorer = dr.make_batched_scorer(mesh, k=10, table_axes=("model",),
                                    batch_axes=("data",))
    dispatch.reset_counters()
    s, i = scorer(torch.as_tensor(q), torch.as_tensor(table), n_valid=300)
    out["scorer"] = (_np(s), _np(i))
    out["scorer_calls"] = dispatch.counter("knn_score").calls
    every = dr.make_batched_scorer(mesh, k=10, table_axes=("data", "model"))
    s, i = every(torch.as_tensor(q), torch.as_tensor(table))
    out["scorer_every"] = (_np(s), _np(i))
    # a table that already lies on the mesh (vocab-parallel, as
    # param_specs lays out an item table)
    from repro_torch.dist.api import P, place
    placed = place(torch.as_tensor(table), mesh, P("model", None))
    s, i = scorer(torch.as_tensor(q), placed, n_valid=300)
    out["scorer_placed"] = (_np(s), _np(i))
    return out


# ----------------------------------- world 4: the forward under rules

def forward_world4(rank, world, jparams, tokens, egnn_case):
    """On (2, 2): STAR (smoke) under ``lm_activation_rules`` and EGNN
    (smoke) under ``gnn_activation_rules``, parameters placed by
    ``param_specs`` as DTensors, each beside its unsharded forward."""
    from repro_torch import convert
    from repro_torch.configs import egnn as egnn_cfg
    from repro_torch.configs import star_encoder
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.api import sharding_rules
    from repro_torch.models import egnn
    from repro_torch.models import transformer as tf
    mesh = _mesh((2, 2), ("data", "model"))

    def placed(params):
        return shd.place_tree(params, mesh, shd.param_specs(
            params, mesh, min_shard_size=1))

    cfg = star_encoder.smoke_config()
    params = convert.transformer_params_from_numpy(jparams, device="cpu")
    tok = torch.as_tensor(tokens)
    plain = tf.forward(params, tok, cfg)[0]
    lm = placed(params)
    with sharding_rules(mesh, shd.lm_activation_rules(mesh, cfg, "train")):
        got = tf.forward(lm, tok, cfg)[0]
    out = {"plain": _np(plain), "sharded": _np(got),
           "placements": _names(got.placements),
           "embed": _names(lm["embed"].placements)}

    ecfg = egnn_cfg.smoke_config()
    eparams, feat, coords, edges = egnn_case
    eparams = convert.egnn_params_from_numpy(eparams, device="cpu")
    args = [torch.as_tensor(a) for a in (feat, coords, edges)]
    e_plain = egnn.forward(eparams, *args, ecfg)
    with sharding_rules(mesh, shd.gnn_activation_rules(mesh)):
        e_got = egnn.forward(placed(eparams), *args, ecfg)
    out["egnn_plain"] = [_np(t) for t in e_plain]
    out["egnn_sharded"] = [_np(t) for t in e_got]
    return out


# ------------------------------- world 2 / 1: train step, checkpoints

def _star_state(mesh=None):
    """STAR (smoke) parameters from a seed and AdamW's state; with a mesh,
    both laid out by ``param_specs`` / ``state_spec``."""
    from repro_torch.configs import star_encoder
    from repro_torch.dist import sharding as shd
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import adamw
    cfg = star_encoder.smoke_config()
    opt = adamw(lr=1e-2, warmup=1)
    params = tf.init_params(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    state = {"params": params, "opt": opt.init(params)}
    if mesh is None:
        return cfg, opt, state, None
    specs = shd.param_specs(params, mesh, min_shard_size=1)
    state_specs = {"params": specs, "opt": opt.state_spec(params, specs)}
    placed = shd.place_tree(state, mesh, state_specs)
    return cfg, opt, placed, state_specs


def _record(loss_fn, state, batch, step_fn):
    """``train.parity``'s record of one step: loss, grad_norm, grads and
    the updated parameters (numpy leaves in JAX order)."""
    from repro_torch.train import step as st
    from repro_torch.train import tree
    _, grads = st.value_and_grad(loss_fn)(state["params"], batch)
    new, m = step_fn(state, batch)
    return {"loss": float(_np(m["loss"])),
            "grad_norm": float(_np(m["grad_norm"])),
            "grads": [_np(g) for g in tree.leaves(grads)],
            "params": [_np(p) for p in tree.leaves(new["params"])]}


def train_world2(rank, world, ckpt_dir):
    """One accumulating step with ``grad_shardings`` on (2, 1) against
    the unsharded step; then the sharded state is saved (step 1)."""
    import functools

    from repro_torch.checkpoint import save_tree
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.api import NamedSharding, sharding_rules
    from repro_torch.train import step as st
    from repro_torch.train import tree
    mesh = _mesh((2, 1), ("data", "model"))
    cfg, opt, plain, _ = _star_state()
    batch = lm_batch(cfg.vocab_size)
    loss_fn = functools.partial(st.lm_loss_fn, cfg=cfg, remat="full")
    ref = _record(loss_fn, plain, batch,
                  st.make_lm_train_step(cfg, opt, accum_steps=2))
    _cfg, _opt, placed, specs = _star_state(mesh)
    pins = tree.map(lambda s: NamedSharding(mesh, s), specs["params"])
    step = st.make_lm_train_step(cfg, opt, accum_steps=2,
                                 grad_shardings=pins)
    with sharding_rules(mesh, shd.lm_activation_rules(mesh, cfg, "train")):
        got = _record(loss_fn, placed, batch, step)
    grad_pl = [_names(p.placements) for p in tree.leaves(placed["params"])]
    save_tree(placed, ckpt_dir, 1)
    return {"ref": ref, "got": got, "param_placements": grad_pl,
            "saved": [_np(t) for t in tree.leaves(placed)]}


def restore_world(rank, world, ckpt_dir, step, save_step):
    """Restore ``step`` onto a (world, 1) mesh laid out by the state's
    specs; save it again as ``save_step`` (None: not)."""
    from repro_torch.checkpoint import restore_tree, save_tree
    from repro_torch.dist.api import NamedSharding
    from repro_torch.train import tree
    mesh = _mesh((world, 1), ("data", "model"))
    _cfg, _opt, template, _ = _star_state()
    _c, _o, _placed, specs = _star_state(mesh)
    shardings = tree.map(lambda s: NamedSharding(mesh, s), specs)
    got = restore_tree(template, ckpt_dir, step, shardings=shardings)
    local = [tuple(t.to_local().shape) for t in tree.leaves(got)
             if t.dim()]
    if save_step is not None:
        save_tree(got, ckpt_dir, save_step)
    return {"leaves": [_np(t) for t in tree.leaves(got)],
            "local_shapes": local,
            "global_shapes": [tuple(t.shape) for t in tree.leaves(got)
                              if t.dim()]}


# ---------------------------------------------- world 4: expert parallel

def moe_world4(rank, world, params, cfg_kw, capacity):
    """``moe_ffn_sharded`` on (2, 2): outputs, aux loss and the gradients
    of sum(y * w) + aux with respect to x, the router, wi and wo."""
    from repro_torch.models import moe
    cfg = moe.MoEConfig(**cfg_kw)
    mesh = _mesh((2, 2), ("data", "model"))
    x, w = moe_inputs(d=params["wi"].shape[1])
    xt = torch.tensor(x, requires_grad=True)
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    out = moe.moe_ffn_sharded(p, xt, cfg, mesh, capacity=capacity)
    (torch.sum(out.y * torch.as_tensor(w)) + out.aux_loss).backward()
    return {"y": _np(out.y), "aux": float(out.aux_loss.detach()),
            "grad_x": xt.grad.numpy(),
            **{f"grad_{k}": t.grad.numpy() for k, t in p.items()}}


def moe_forward_world4(rank, world, jparams, tokens):
    """deepseek-v3 (smoke, f32) under ``lm_activation_rules`` on (2, 2):
    its MoE layers route through ``moe_ffn_sharded``."""
    import dataclasses

    from repro_torch import convert
    from repro_torch.configs import deepseek_v3_671b
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.api import sharding_rules
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(deepseek_v3_671b.smoke_config(),
                              dtype=torch.float32)
    params = convert.transformer_params_from_numpy(jparams, device="cpu")
    mesh = _mesh((2, 2), ("data", "model"))
    placed = shd.place_tree(params, mesh,
                            shd.param_specs(params, mesh, min_shard_size=1))
    with sharding_rules(mesh, shd.lm_activation_rules(mesh, cfg, "train")):
        logits, aux, _h, _kv = tf.forward(placed, torch.as_tensor(tokens),
                                          cfg)
    return {"logits": _np(logits), "aux": float(_np(aux))}


def moe_world1(rank, world, params, cfg_kw, capacity):
    """At a world of one, ``moe_ffn_sharded`` on a (1, 1) mesh and
    ``moe_ffn`` on the same inputs."""
    from repro_torch.models import moe
    cfg = moe.MoEConfig(**cfg_kw)
    x, _w = moe_inputs(d=params["wi"].shape[1])
    p = {k: torch.as_tensor(v) for k, v in params.items()}
    a = moe.moe_ffn_sharded(p, torch.as_tensor(x), cfg,
                            _mesh((1, 1), ("data", "model")),
                            capacity=capacity)
    b = moe.moe_ffn(p, torch.as_tensor(x), cfg, capacity=capacity)
    return {"sharded": (_np(a.y), float(a.aux_loss)),
            "plain": (_np(b.y), float(b.aux_loss))}


# -------------------------------------------- one launch, several bodies

def world8(rank, world):
    return {"api": api_world8(rank, world),
            "retrieval": retrieval_world8(rank, world)}


def moe_world4_all(rank, world, params, cfg_kw, capacities, jparams,
                   tokens):
    return {"moe": {c: moe_world4(rank, world, params, cfg_kw, c)
                    for c in capacities},
            "forward": moe_forward_world4(rank, world, jparams, tokens)}


# ------------------------------------------------- the launcher's tests

def _echo(rank, world, value):
    import torch.distributed as dist
    t = torch.tensor([rank + 1.0])
    dist.all_reduce(t)
    return {"rank": rank, "world": world, "sum": float(t), "value": value}


def _fail(rank, world):
    if rank == 1:
        raise ValueError("rank one fails on purpose")
    return rank


def _hang(rank, world):
    import torch.distributed as dist
    if rank == 0:
        time.sleep(60)
    dist.barrier()


def test_run_ranks_returns_rank_zeros_value():
    got = run_ranks(_echo, 2, np.arange(3))
    assert (got["rank"], got["world"], got["sum"]) == (0, 2, 3.0)
    np.testing.assert_array_equal(got["value"], np.arange(3))


def test_run_ranks_raises_a_ranks_error():
    with pytest.raises(RuntimeError, match="rank 1:(.|\n)*on purpose"):
        run_ranks(_fail, 2)


def test_run_ranks_kills_a_world_that_hangs():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish within 8"):
        run_ranks(_hang, 2, timeout=8)
    assert time.monotonic() - t0 < 30


def test_rank_module_imports_no_jax():
    """A rank imports this module: it must not pull JAX in."""
    import subprocess
    import sys
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys; sys.modules['jax'] = None; "
            "import test_torch_dist_ranks")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(here, "..", "src"), here]))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
