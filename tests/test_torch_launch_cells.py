"""The port's cell builders (``repro_torch.launch.cells``) against the JAX
package's ``repro.launch.cells``, on the CPU.

For each of the 40 assigned cells, built on a 2 x 4 ("data", "model")
mesh (the JAX side on conftest's 8 host devices with ``AxisType.Auto``
axes, the port's on a device-free ``MeshShape``): the kind, every argument
leaf's shape and dtype, every input and output sharding spec, the rules
and ``meta`` (``model_flops`` included) are equal, exactly.

Then the cells' step functions compute what JAX's do on the same numpy
inputs, at the smoke configs (the arch modules' ``full_config`` swapped
for ``smoke_config`` in both packages, so the builders run as they are):
the LM cells' train-step loss and updated parameters, prefill logits and
caches, and decode logits; the recsys cells' train step, serve logits or
top-k and retrieval top-k; the EGNN cells' train step at the two small
graph shapes.  They run at a reduced batch (the step functions do not
depend on the argument shapes; an LM train cell in at most 4
microbatches, in both packages) on (1, 1) meshes: the port's over a
world of one gloo rank, JAX's over one host device.  Tolerances:
a train step by ``train.parity.assert_steps_agree`` (loss and grad_norm
rtol 1e-5, parameters atol 2e-5 but where the first update is a sign of
f32 noise), logits and caches atol 1e-4 (f32 sums in other orders),
top-k scores 1e-5 and ids equal where the scores are apart by more than
1e-5.
"""

import dataclasses
import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType
from jax.sharding import NamedSharding as JNamedSharding

from repro.configs import registry as jregistry
from repro.dist.api import sharding_rules as jsharding_rules
from repro.launch import cells as jcells
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.dist.api import MeshShape, NamedSharding, sharding_rules
from repro_torch.launch import cells
from repro_torch.train import tree

jax.config.update("jax_platform_name", "cpu")

CELLS = registry.all_cells()


def _jmesh(shape=(2, 4), names=("data", "model")):
    n = int(np.prod(shape))
    return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(
        shape), devices=jax.devices()[:n])


def _jkey(path) -> str:
    return "|".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _jleaves(t, leaf_type=None) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        t, is_leaf=(lambda x: isinstance(x, leaf_type)) if leaf_type
        else None)
    return {_jkey(p): v for p, v in flat}


def _leaves(t) -> dict:
    return {tree.path_key(p): v for p, v in tree.leaves_with_path(t)}


def _dtype(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return np.dtype(x.dtype).name


def _specs(t, jax_side: bool) -> dict:
    if jax_side:
        return {k: tuple(v.spec)
                for k, v in _jleaves(t, JNamedSharding).items()}
    return {k: tuple(v.spec) for k, v in _leaves(t).items()}


@pytest.fixture(scope="module")
def jmesh():
    return _jmesh()


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}@{s}" for a, s in CELLS])
def test_cell_matches_jax_builder(arch, shape, jmesh):
    want = jcells.build_cell(arch, shape, jmesh)
    got = cells.build_cell(arch, shape, MeshShape(("data", "model"),
                                                  (2, 4)))
    assert (got.arch, got.shape, got.kind) == (want.arch, want.shape,
                                               want.kind)
    ja, ga = _jleaves(want.args), _leaves(got.args)
    assert list(ga) == list(ja)
    for k, leaf in ga.items():
        assert leaf.device.type == "meta", k
        assert tuple(leaf.shape) == tuple(ja[k].shape), k
        assert _dtype(leaf) == _dtype(ja[k]), k
    assert _specs(got.in_shardings, False) == _specs(want.in_shardings, True)
    assert _specs(got.out_shardings, False) == _specs(want.out_shardings,
                                                      True)
    assert all(isinstance(s, NamedSharding)
               for s in tree.leaves(got.in_shardings))
    assert {k: tuple(v) for k, v in got.rules.items()} == \
        {k: tuple(v) for k, v in want.rules.items()}
    assert got.meta == want.meta
    assert type(got.meta["model_flops"]) is type(want.meta["model_flops"])


# --------------------------------------------- smoke configs, computed

@pytest.fixture(scope="module")
def jmesh11():
    """The JAX side of the computed cells: a (1, 1) mesh, so both run the
    one-device function (on 2 x 4 JAX's MoE takes its expert-parallel
    rule, which routes per data shard)."""
    return _jmesh((1, 1))


@pytest.fixture(scope="module")
def host_mesh():
    """A (1, 1) mesh over a world of one gloo rank in this process,
    destroyed at teardown."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method="file://" + os.path.join(
            tmp, "rendezvous"), rank=0, world_size=1)
        try:
            yield make_host_mesh(device_type="cpu")
        finally:
            dist.destroy_process_group()


@pytest.fixture
def smoke(monkeypatch):
    """Both packages' arch modules give their smoke configs as the full
    ones (EGNN's with the cell's feature width and readout)."""
    def swap(mod):
        small = mod.smoke_config()
        if mod.FAMILY == "gnn":
            monkeypatch.setattr(mod, "full_config", lambda d_feat=1433,
                                readout="node": dataclasses.replace(
                                    small, d_feat_in=d_feat,
                                    readout=readout))
        else:
            monkeypatch.setattr(mod, "full_config", lambda: small)
    for arch in registry.ASSIGNED:
        swap(registry.get(arch))
        swap(jregistry.get(arch))


def _np(x):
    return convert.to_numpy(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _values(rng, leaf, arch, key, vocab=None):
    """Inputs for one argument leaf, the same numpy arrays for both."""
    shape, dt = tuple(leaf.shape), _dtype(leaf)
    if dt == "int32":
        if key.endswith("cur_len") or shape == ():
            return np.int32(5)
        hi = vocab or 8
        out = rng.integers(0, hi, shape).astype(np.int32)
        if key in ("items", "pos", "neg"):
            out[:, :3] = -1                     # left pads
        return out
    if key == "label":
        return (rng.random(shape) < 0.5).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _jparams(arch, cfg, key=0):
    """The JAX package's init of the cell's params and the port's copy."""
    from repro.models import egnn as jegnn
    from repro.models import recsys as jrs
    from repro.models import transformer as jtf
    k = jax.random.key(key)
    fam = registry.get(arch).FAMILY
    if fam == "lm":
        jp = jtf.init_params(k, cfg)
        return jp, convert.transformer_params_from_numpy(jp, device="cpu")
    if fam == "gnn":
        jp = jegnn.init_params(k, cfg)
        return jp, convert.egnn_params_from_numpy(jp, device="cpu")
    init = {"dlrm-rm2": jrs.dlrm_init, "xdeepfm": jrs.xdeepfm_init}.get(
        arch, jrs.seqrec_init)
    jp = init(k, cfg)
    return jp, jax.tree.map(lambda a: torch.tensor(np.array(a)), jp)


def _jcfg(arch):
    return jregistry.get(arch).full_config()


def _train_agrees(arch, jcell, cell, jp, tp, batch, loss_fn, host_mesh):
    """One step of each cell from the same parameters and batch, held by
    ``train.parity.assert_steps_agree`` at the first step's learning rate
    (the JAX step the reference; the signless elements, whose first
    update is a sign in f32 noise, judged by the port's gradients of the
    cell's loss)."""
    from repro_torch.train import parity
    from repro_torch.train import step as st
    mod = registry.get(arch)
    jopt = jcells.make_optimizer(mod.OPTIMIZER)
    jst, jm = jax.jit(jcell.fn)({"params": jp, "opt": jopt.init(jp)},
                                jax.tree.map(jnp.asarray, batch))
    opt = cells.make_optimizer(mod.OPTIMIZER)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    _, grads = st.value_and_grad(loss_fn)(tp, tb)
    with sharding_rules(host_mesh, cell.rules):
        tst, tm = cell.fn({"params": tp, "opt": opt.init(tp)}, tb)
    g = [_np(x.float()) for x in tree.leaves(grads)]

    def record(m, params):
        return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "grads": g, "params": [_np(q).astype(np.float32)
                                       for q in tree.leaves(params)]}
    # the schedules' first step: lr * 2 / warmup (warmup 100)
    lr_t = {"adamw": 1e-3, "adafactor": 1e-2}[mod.OPTIMIZER] * 2 / 100
    parity.assert_steps_agree(
        record(jm, jax.tree.map(np.asarray, jst["params"])),
        record(tm, tst["params"]), f"{arch} cell step", lr_t)


LM_SMOKE = [(a, s) for a, s in CELLS if registry.get(a).FAMILY == "lm"
            and s != "long_500k"]
RECSYS_SMOKE = [(a, s) for a, s in CELLS
                if registry.get(a).FAMILY == "recsys"]
GNN_SMOKE = [("egnn", "molecule"), ("egnn", "full_graph_sm")]


def _close(got, want, atol):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=atol,
                               atol=atol)


@pytest.mark.parametrize("arch,shape", LM_SMOKE,
                         ids=[f"{a}@{s}" for a, s in LM_SMOKE])
def test_lm_smoke_cell_computes_what_jax_does(arch, shape, smoke, jmesh11,
                                              host_mesh, monkeypatch):
    # at most 4 microbatches in both packages' train cells: each one is
    # the same step again
    for mod in (registry.get(arch), jregistry.get(arch)):
        monkeypatch.setattr(mod, "TRAIN_ACCUM_STEPS",
                            min(getattr(mod, "TRAIN_ACCUM_STEPS", 1), 4))
    jcell = jcells.build_cell(arch, shape, jmesh11)
    cell = cells.build_cell(arch, shape, host_mesh)
    jcfg = _jcfg(arch)
    jp, tp = _jparams(arch, jcfg)
    rng = np.random.default_rng(1)
    mod = registry.get(arch)
    b = max(2, mod.TRAIN_ACCUM_STEPS) if shape == "train_4k" else 2
    s = 16
    tok = rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    if shape == "train_4k":
        from repro_torch.train import step as st
        if mod.ACCUM_DTYPE == torch.bfloat16:
            # deepseek sums its microbatches' gradients in bf16: a sum
            # that cancels to within bf16 rounding has no sign, and the
            # first update is a sign, so every microbatch gets the same rows
            tok = np.repeat(tok[:b // mod.TRAIN_ACCUM_STEPS],
                            mod.TRAIN_ACCUM_STEPS, axis=0)
        batch = {"tokens": tok, "labels": np.roll(tok, -1, 1)}
        _train_agrees(arch, jcell, cell, jp, tp, batch, functools.partial(
            st.lm_loss_fn, cfg=mod.full_config()), host_mesh)
        return
    if shape == "prefill_32k":
        with jsharding_rules(jmesh11, jcell.rules):
            jl, jc = jax.jit(jcell.fn)(jp, jnp.asarray(tok))
        with sharding_rules(host_mesh, cell.rules):
            tl, tc = cell.fn(tp, torch.as_tensor(tok))
        _close(tl, jl, 1e-4)
        for w, g in zip(jax.tree.leaves(jc), tree.leaves(tc)):
            assert tuple(g.shape) == w.shape
            _close(g, w, 1e-4)
        return
    # decode: one token against caches filled by a prefill of s tokens
    from repro.models import transformer as jtf
    from repro_torch.models import transformer as tf
    kv = 32
    _, _, _, jcache = jtf.forward(jp, jnp.asarray(tok), jcfg,
                                  return_kv=True, kv_len=kv)
    _, _, _, tcache = tf.forward(tp, torch.as_tensor(tok), mod.full_config(),
                                 return_kv=True, kv_len=kv)
    nxt = rng.integers(0, jcfg.vocab_size, (b,)).astype(np.int32)
    jl, _ = jax.jit(jcell.fn)(jp, jnp.asarray(nxt), jcache,
                              jnp.asarray(s + 1, jnp.int32))
    with sharding_rules(host_mesh, cell.rules):
        tl, _ = cell.fn(tp, torch.as_tensor(nxt), tcache,
                        torch.tensor(s + 1, dtype=torch.int32))
    _close(tl, jl, 1e-4)


@pytest.mark.parametrize("arch,shape", RECSYS_SMOKE,
                         ids=[f"{a}@{s}" for a, s in RECSYS_SMOKE])
def test_recsys_smoke_cell_computes_what_jax_does(arch, shape, smoke, jmesh11,
                                                  host_mesh):
    jcell = jcells.build_cell(arch, shape, jmesh11)
    cell = cells.build_cell(arch, shape, host_mesh)
    jcfg = _jcfg(arch)
    jp, tp = _jparams(arch, jcfg)
    rng = np.random.default_rng(2)
    vocab = jcfg.vocab
    n = 64                                     # rows, for every shape
    if cell.kind == "train":
        from repro_torch.train import step as st
        batch = {k: _values(rng, v[:n] if v.dim() else v, arch, k, vocab)
                 for k, v in cell.args[1].items()}
        loss = (st.seqrec_loss_fn if arch in ("sasrec", "bert4rec")
                else st.ctr_loss_fn)
        _train_agrees(arch, jcell, cell, jp, tp, batch, functools.partial(
            loss, cfg=registry.get(arch).full_config()), host_mesh)
        return
    rows = 1 if cell.kind == "retrieval" else n
    keys = ("dense", "sparse") if arch == "dlrm-rm2" else (
        ("sparse",) if arch == "xdeepfm" else ("items",))
    inputs = [_values(rng, a[:rows], arch, k, vocab)
              for k, a in zip(keys, cell.args[1:])]
    with jsharding_rules(jmesh11, jcell.rules):
        want = jax.jit(jcell.fn)(jp, *map(jnp.asarray, inputs))
    with sharding_rules(host_mesh, cell.rules):
        got = cell.fn(tp, *map(torch.as_tensor, inputs))
    if cell.kind == "serve" and arch in ("dlrm-rm2", "xdeepfm"):
        _close(got, want, 1e-4)
        return
    (gs, gi), (ws, wi) = got, want
    _close(gs, ws, 1e-5)
    ws, wi, gi = np.asarray(ws), np.asarray(wi), _np(gi)
    # ids equal wherever the scores around them are apart
    apart = np.ones_like(ws, dtype=bool)
    gap = np.abs(np.diff(ws, axis=1)) > 1e-5
    apart[:, :-1] &= gap
    apart[:, 1:] &= gap
    np.testing.assert_array_equal(gi[apart], wi[apart])


@pytest.mark.parametrize("arch,shape", GNN_SMOKE,
                         ids=[f"{a}@{s}" for a, s in GNN_SMOKE])
def test_gnn_smoke_cell_computes_what_jax_does(arch, shape, smoke, jmesh11,
                                               host_mesh):
    from repro_torch.data import graph
    jcell = jcells.build_cell(arch, shape, jmesh11)
    cell = cells.build_cell(arch, shape, host_mesh)
    jcfg = jregistry.get(arch).full_config(
        d_feat=cell.args[1]["feat"].shape[1],
        readout="graph" if shape == "molecule" else "node")
    jp, tp = _jparams(arch, jcfg)
    geom = registry.get(arch).SHAPES[shape]
    if shape == "molecule":
        feat, coords, edges, gids, labels = graph.batched_molecules(
            0, geom["batch"], geom["n_nodes"], geom["n_edges"],
            geom["d_feat"], jcfg.n_classes)
        batch = {"feat": feat, "coords": coords, "edge_index": edges,
                 "graph_ids": gids, "labels": labels}
    else:
        g = graph.random_graph(0, geom["n_nodes"], geom["n_edges"],
                               geom["d_feat"], jcfg.n_classes)
        batch = {"feat": g.node_feat, "coords": g.coords,
                 "edge_index": g.edge_index, "labels": g.labels}
    for k, leaf in cell.args[1].items():       # the cell's shapes, padded
        assert batch[k].shape[-1] <= leaf.shape[-1]
    from repro_torch.train import step as st
    _train_agrees(arch, jcell, cell, jp, tp, batch, functools.partial(
        st.egnn_loss_fn, cfg=registry.get(arch).full_config(
            d_feat=geom["d_feat"], readout=jcfg.readout),
        n_graphs=geom.get("batch")), host_mesh)
