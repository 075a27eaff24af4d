"""The port's losses and train steps against the JAX package, on the CPU.

The JAX package's parameters (from a JAX key) are carried into the port
(``repro_torch.convert``) and the same numpy batches go through both.

  * ``cross_entropy`` with and without z-loss, labels < 0 masked: within
    rtol 1e-6.
  * One ``make_lm_train_step`` step for each LM smoke config, with its
    config's optimizer as ``test_arch_smoke.py`` builds it and ``remat=
    "full"``: loss and ``grad_norm`` within rtol 1e-5; the gradients leaf
    by leaf (``value_and_grad``) within atol 1e-6 + rtol 1e-4 of the leaf's
    largest |gradient| (f32 sums in other orders through a few layers: the
    JAX package's own jit and eager gradients of the llama4 smoke embedding
    differ by 1.4e-6 where it sums over repeated tokens); the updated
    parameters within atol 2e-5.  The first update is sign-like (AdamW's
    ``g / (|g| + eps)``, Adafactor's ``g / sqrt(g * g + 1e-30)``): an
    element whose gradient is below the gradient tolerance has no sign in
    f32, so there the two packages' steps may differ by the whole step,
    and the check is that neither moved more than ``2 * lr_t``.
  * Remat ``none``, ``full`` and ``dots``: loss and gradients equal bit for
    bit.
  * Accumulation over 4 microbatches equals one batch (the port's twin of
    ``test_arch_smoke.py``'s, at its bar: atol 2e-5 at lr 1e-2).
  * The CTR BCE (DLRM, xDeepFM through the gather branch), the seqrec BCE
    (SASRec, BERT4Rec) and the EGNN CE (node and graph readout): loss,
    gradients and one step, at the bars above.
  * The loss falls over 20 steps on ``TokenStream`` (``test_arch_smoke.py``
    's bar); a chunked seqrec backward equals the unchunked one; the
    embedding-bag kernel refuses a table that requires a gradient.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import common as jcm
from repro.models import egnn as jegnn
from repro.models import recsys as jrs
from repro.models import transformer as jtf
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.data import graph
from repro_torch.data.lm import LMBatchSpec, TokenStream
from repro_torch.data.recsys import CTRSpec, CTRStream, SessionStream
from repro_torch.kernels import dispatch
from repro_torch.models import common as cm
from repro_torch.models import recsys as rs
from repro_torch.models import transformer as tf
from repro_torch.train import optimizer as topt
from repro_torch.train import parity
from repro_torch.train import step as tstep
from repro_torch.train import tree

jax.config.update("jax_platform_name", "cpu")

LM_ARCHS = ["star-encoder", "deepseek-v3-671b", "llama4-scout-17b-16e",
            "chatglm3-6b", "mistral-large-123b", "gemma2-9b"]


def _np(x):
    return convert.to_numpy(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _opts(mod, **kw):
    """The JAX and port optimizers of a config, as test_arch_smoke.py."""
    if mod.OPTIMIZER == "adamw":
        kw = {"lr": 1e-3, **kw}
    else:
        kw = {"lr": 1e-2, "stochastic_rounding": False, **kw}
    return (getattr(jopt, mod.OPTIMIZER)(**kw),
            topt.OPTIMIZERS[mod.OPTIMIZER](**kw))


def _step_pair(jloss, tloss, jp, tp, batch, jo, to, lr_t):
    """One step of each package from the same parameters, held by
    ``train.parity.assert_steps_agree`` (the JAX package's step the
    reference): loss, grad_norm, gradients and updated parameters."""
    jb = jax.tree.map(jnp.asarray, batch)
    _, jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp, jb)
    _, tg = tstep.value_and_grad(tloss)(tp, batch)
    jst, jm = jax.jit(jstep.make_train_step(jloss, jo))(
        {"params": jp, "opt": jo.init(jp)}, jb)
    tst, tm = tstep.make_train_step(tloss, to)(
        {"params": tp, "opt": to.init(tp)}, batch)

    def record(m, grads, params):
        return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "grads": [_np(g) for g in jax.tree.leaves(grads)],
                "params": [_np(q) for q in jax.tree.leaves(params)]}

    parity.assert_steps_agree(record(jm, jg, jst["params"]),
                              record(tm, tg, tst["params"]), "step", lr_t)
    return tm


# ------------------------------------------------------------------ loss

@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy_matches_jax(z_loss):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[0, :3] = -1
    labels[2] = -5
    want = jcm.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                             z_loss=z_loss)
    got = cm.cross_entropy(torch.tensor(logits), torch.tensor(labels),
                           z_loss=z_loss)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    empty = cm.cross_entropy(torch.tensor(logits), torch.full((3, 7), -1))
    assert float(empty) == 0.0


# -------------------------------------------------------------------- LM

def _lm(arch, seed=0):
    jmod, tmod = jregistry.get(arch), registry.get(arch)
    jcfg, cfg = jmod.smoke_config(), tmod.smoke_config()
    jp = jtf.init_params(jax.random.key(seed), jcfg)
    return jmod, tmod, jcfg, cfg, jp


def _lm_batch(vocab, b=2, s=16, seed=1):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (b, s)).astype(np.int32)
    lab = np.roll(tok, -1, 1)
    lab[0, -3:] = -1
    return {"tokens": tok, "labels": lab}


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_train_step_matches_jax(arch):
    jmod, tmod, jcfg, cfg, jp = _lm(arch)
    jo, to = _opts(jmod)
    tp = convert.transformer_params_from_numpy(jp, device="cpu")
    lr = 1e-3 if jmod.OPTIMIZER == "adamw" else 1e-2
    tm = _step_pair(functools.partial(jstep.lm_loss_fn, cfg=jcfg,
                                      remat="full"),
                    functools.partial(tstep.lm_loss_fn, cfg=cfg,
                                      remat="full"),
                    jp, tp, _lm_batch(jcfg.vocab_size), jo, to,
                    lr * 2 / 100)
    assert set(tm) == {"ce", "aux", "loss", "grad_norm"}


@pytest.mark.parametrize("arch", ["star-encoder", "deepseek-v3-671b",
                                  "llama4-scout-17b-16e"])
def test_remat_policies_equal_bit_for_bit(arch):
    _, _, _, cfg, jp = _lm(arch)
    tp = convert.transformer_params_from_numpy(jp, device="cpu")
    batch = _lm_batch(cfg.vocab_size)
    outs = [tstep.value_and_grad(functools.partial(
        tstep.lm_loss_fn, cfg=cfg, remat=r))(tp, batch)
        for r in tf.REMAT_POLICIES]
    (l0, m0), g0 = outs[0]
    for (l, m), g in outs[1:]:
        assert torch.equal(l, l0) and torch.equal(m["aux"], m0["aux"])
        assert all(torch.equal(a, b)
                   for a, b in zip(tree.leaves(g), tree.leaves(g0)))


def test_grad_accumulation_matches_full_batch():
    _, tmod, _, cfg, jp = _lm("star-encoder")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, 1)}
    outs, losses = [], []
    for accum in (1, 4):
        opt = topt.adamw(lr=1e-2, warmup=1)
        tp = convert.transformer_params_from_numpy(jp, device="cpu")
        step = tstep.make_lm_train_step(cfg, opt, accum_steps=accum,
                                        remat="none")
        st, m = step({"params": tp, "opt": opt.init(tp)}, batch)
        outs.append(st["params"]["embed"])
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), atol=2e-5)
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)


def test_accumulator_dtype_and_contiguous_microbatches():
    """bf16 accumulation (deepseek's ACCUM_DTYPE) runs on a bf16 model and
    microbatch i is rows [i*B/a, (i+1)*B/a): a loss that records its rows
    sees them in order."""
    seen = []

    def loss_fn(p, b):
        seen.append(b["x"][:, 0].tolist())
        return (p["w"] * b["x"].float()).sum(), {}

    w = torch.ones(3, dtype=torch.bfloat16)
    opt = topt.adamw(lr=1e-2, warmup=1)
    step = tstep.make_train_step(loss_fn, opt, accum_steps=4,
                                 accum_dtype=torch.bfloat16)
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    st, m = step({"params": {"w": w}, "opt": opt.init({"w": w})}, {"x": x})
    assert seen == [[0, 3], [6, 9], [12, 15], [18, 21]]
    assert st["params"]["w"].dtype == torch.bfloat16
    np.testing.assert_allclose(float(m["loss"]), x.sum() / 4)


def test_lm_loss_falls_on_token_stream():
    cfg = registry.get("star-encoder").smoke_config()
    gen = torch.Generator().manual_seed(0)
    params = tf.init_params(cfg, device="cpu", generator=gen)
    opt = topt.adamw(lr=3e-3, warmup=1)
    step = tstep.make_lm_train_step(cfg, opt, remat="none")
    stream = TokenStream(LMBatchSpec(global_batch=8, seq_len=32,
                                     vocab_size=cfg.vocab_size),
                         device="cpu")
    state = {"params": params, "opt": opt.init(params)}
    losses = []
    for i in range(20):
        state, m = step(state, stream.batch(i))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses


# ----------------------------------------------------------- the cells'

def _jax_ctr_loss(params, batch, cfg):
    """``launch/cells.py``'s CTR closure."""
    args = ([batch["dense"], batch["sparse"]] if "dense" in batch
            else [batch["sparse"]])
    fwd = jrs.dlrm_forward if "dense" in batch else jrs.xdeepfm_forward
    logits = fwd(params, *args, cfg=cfg)
    lab = batch["label"]
    return jnp.mean(jnp.maximum(logits, 0) - logits * lab
                    + jnp.log1p(jnp.exp(-jnp.abs(logits)))), {}


@pytest.mark.parametrize("arch", ["dlrm-rm2", "xdeepfm"])
def test_ctr_loss_and_step_match_jax(arch):
    jcfg, cfg = (jregistry.get(arch).smoke_config(),
                 registry.get(arch).smoke_config())
    init = jrs.dlrm_init if arch == "dlrm-rm2" else jrs.xdeepfm_init
    jp = init(jax.random.key(0), jcfg)
    tp = convert.recsys_params_from_numpy(jp, device="cpu")
    dense = arch == "dlrm-rm2"
    spec = CTRSpec(n_dense=13, n_sparse=cfg.n_sparse, vocab=cfg.vocab,
                   multi_hot=cfg.multi_hot if dense else 1)
    batch = CTRStream(spec).batch(0, 32)
    if not dense:
        del batch["dense"]
    jo, to = _opts(jregistry.get(arch), lr=1e-2, warmup=1)
    _step_pair(functools.partial(_jax_ctr_loss, cfg=jcfg),
               functools.partial(tstep.ctr_loss_fn, cfg=cfg),
               jp, tp, batch, jo, to, 1e-2)


@pytest.mark.parametrize("arch", ["sasrec", "bert4rec"])
def test_seqrec_loss_and_step_match_jax(arch):
    jcfg, cfg = (jregistry.get(arch).smoke_config(),
                 registry.get(arch).smoke_config())
    jp = jrs.seqrec_init(jax.random.key(0), jcfg)
    tp = convert.seqrec_params_from_numpy(jp, device="cpu")
    batch = SessionStream(cfg.vocab, cfg.max_len, seed=3).batch(0, 16)

    def jloss(p, b):
        return jrs.seqrec_bce_loss(p, b["items"], b["pos"], b["neg"],
                                   jcfg), {}

    jo, to = _opts(jregistry.get(arch), lr=1e-2, warmup=1)
    _step_pair(jloss, functools.partial(tstep.seqrec_loss_fn, cfg=cfg),
               jp, tp, batch, jo, to, 1e-2)


@pytest.mark.parametrize("readout", ["node", "graph"])
def test_egnn_loss_and_step_match_jax(readout):
    import dataclasses
    jcfg = dataclasses.replace(jregistry.get("egnn").smoke_config(),
                               readout=readout)
    cfg = dataclasses.replace(registry.get("egnn").smoke_config(),
                              readout=readout)
    jp = jegnn.init_params(jax.random.key(0), jcfg)
    tp = convert.egnn_params_from_numpy(jp, device="cpu")
    if readout == "node":
        g = graph.random_graph(0, 60, 300, cfg.d_feat_in, cfg.n_classes)
        edges = g.edge_index.copy()
        edges[:, -20:] = -1                       # padded edges
        labels = g.labels.copy()
        labels[::3] = -1                          # unlabelled nodes
        batch = {"feat": g.node_feat, "coords": g.coords,
                 "edge_index": edges, "labels": labels}
        n_graphs = None
    else:
        feat, coords, edges, gids, labels = graph.batched_molecules(
            0, 4, 8, 16, cfg.d_feat_in, cfg.n_classes)
        batch = {"feat": feat, "coords": coords, "edge_index": edges,
                 "graph_ids": gids, "labels": labels}
        n_graphs = 4

    def jloss(p, b):
        logits, _ = jegnn.forward(p, b["feat"], b["coords"],
                                  b["edge_index"], jcfg,
                                  graph_ids=b.get("graph_ids"),
                                  n_graphs=n_graphs)
        return jcm.cross_entropy(logits[None], b["labels"][None]), {}

    jo, to = _opts(jregistry.get("egnn"), lr=1e-2, warmup=1)
    _step_pair(jloss, functools.partial(tstep.egnn_loss_fn, cfg=cfg,
                                        n_graphs=n_graphs),
               jp, tp, batch, jo, to, 1e-2)


def test_chunked_seqrec_backward_equals_unchunked(monkeypatch):
    cfg = registry.get("bert4rec").smoke_config()
    tp = rs.seqrec_init(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    batch = SessionStream(cfg.vocab, cfg.max_len, seed=3).batch(0, 24)
    grad = tstep.value_and_grad(functools.partial(tstep.seqrec_loss_fn,
                                                  cfg=cfg))
    (l1, _), g1 = grad(tp, batch)
    # a budget of 5 rows' intermediates: chunks of 4 rows
    row = 4 * cfg.max_len * (cfg.n_heads * cfg.max_len
                             + cfg.d_ff_mult * cfg.embed_dim)
    monkeypatch.setattr(rs, "ENCODE_BUDGET", 5 * row)
    assert rs.encode_rows(cfg) == 4
    (l4, _), g4 = grad(tp, batch)
    np.testing.assert_allclose(float(l4), float(l1), rtol=1e-6)
    for a, b in zip(tree.leaves(g1), tree.leaves(g4)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-7,
                                   rtol=1e-5)


def test_embedding_bag_kernel_refuses_a_gradient(monkeypatch):
    """On the card the kernel would hand back rows without history: it
    raises instead (the CPU stands in for the card here by the dispatch
    rule; the check comes before any build or launch)."""
    monkeypatch.setattr(dispatch, "is_kernel", lambda t: True)
    tables = torch.randn(3, 10, 4, requires_grad=True)
    idx = torch.zeros(2, 3, 1, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="use_kernel=False"):
        rs.field_pool(tables, idx)
    monkeypatch.undo()
    out = rs.field_pool(tables, idx, use_kernel=False)
    out.sum().backward()
    assert tables.grad is not None and float(tables.grad.abs().sum()) > 0


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_field_pool_gather_branch_matches_jax(mode):
    """The gather branch against the JAX package's (``use_kernel=False``):
    pads zeroed, ids past the vocab clamped in their field, empty bags 0."""
    rng = np.random.default_rng(4)
    tables = rng.standard_normal((3, 20, 5)).astype(np.float32)
    idx = rng.integers(-1, 24, (6, 3, 4)).astype(np.int32)
    idx[0, 1] = -1
    want = jrs.field_pool(jnp.asarray(tables), jnp.asarray(idx), mode,
                          use_kernel=False)
    got = rs.field_pool(torch.tensor(tables), torch.tensor(idx), mode,
                        use_kernel=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
