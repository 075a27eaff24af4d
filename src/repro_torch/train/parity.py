"""One train step of each smoke config, on any device, and the rule by which
two such steps agree: the card against the CPU path (``chip_smoke.py``'s
``[train]`` and the GPU tests).

``smoke_step(arch, device)`` builds the arch's smoke config from a seeded
CPU generator (the same numbers on every device), a batch from the port's
data streams, its loss (``train.step``'s) and its config's optimizer
(lr 1e-2, warmup 1; Adafactor without stochastic rounding: f32 smoke
configs round nothing), then runs ``value_and_grad`` and one step.

``assert_steps_agree`` holds two such records to the tolerances of the
port's CPU tests against the JAX package: loss and ``grad_norm`` within
rtol 1e-5; gradients leaf by leaf within atol 1e-6 + rtol 1e-4 of the
leaf's largest |gradient|; updated parameters within atol 2e-5, except
where the reference gradient is below that tolerance (the first update is
sign-like and such a gradient has no sign in f32): there neither step may
exceed ``2 * lr``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core.cache_ops import to_numpy
from repro_torch.data import graph
from repro_torch.data.recsys import CTRSpec, CTRStream, SessionStream
from repro_torch.models import egnn
from repro_torch.models import recsys as rs
from repro_torch.models import transformer as tf
from repro_torch.train import step as st
from repro_torch.train import tree
from repro_torch.train.optimizer import OPTIMIZERS

__all__ = ["SMOKE_ARCHS", "smoke_step", "assert_steps_agree", "LR"]

SMOKE_ARCHS = ("star-encoder", "deepseek-v3-671b", "llama4-scout-17b-16e",
               "dlrm-rm2", "xdeepfm", "sasrec", "bert4rec", "egnn")
LR = 1e-2
LOSS_RTOL, G_ATOL, G_RTOL, P_ATOL = 1e-5, 1e-6, 1e-4, 2e-5


def _case(arch: str, seed: int):
    """(params on the CPU, batch of numpy arrays, loss_fn)."""
    mod = registry.get(arch)
    cfg = mod.smoke_config()
    kw = dict(device="cpu", generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    if mod.FAMILY == "lm":
        tok = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
        lab = np.roll(tok, -1, 1)
        lab[0, -3:] = -1
        return (tf.init_params(cfg, **kw), {"tokens": tok, "labels": lab},
                functools.partial(st.lm_loss_fn, cfg=cfg, remat="full"))
    if arch in ("dlrm-rm2", "xdeepfm"):
        dlrm = arch == "dlrm-rm2"
        spec = CTRSpec(n_sparse=cfg.n_sparse, vocab=cfg.vocab,
                       multi_hot=cfg.multi_hot if dlrm else 1, seed=seed)
        batch = CTRStream(spec).batch(0, 64)
        if not dlrm:
            del batch["dense"]
        init = rs.dlrm_init if dlrm else rs.xdeepfm_init
        return (init(cfg, **kw), batch,
                functools.partial(st.ctr_loss_fn, cfg=cfg))
    if arch in ("sasrec", "bert4rec"):
        batch = SessionStream(cfg.vocab, cfg.max_len, seed=seed).batch(0, 32)
        return (rs.seqrec_init(cfg, **kw), batch,
                functools.partial(st.seqrec_loss_fn, cfg=cfg))
    g = graph.random_graph(seed, 200, 1500, cfg.d_feat_in, cfg.n_classes)
    batch = {"feat": g.node_feat, "coords": g.coords,
             "edge_index": g.edge_index, "labels": g.labels}
    return (egnn.init_params(cfg, **kw), batch,
            functools.partial(st.egnn_loss_fn, cfg=cfg))


def smoke_step(arch: str, device, seed: int = 0) -> dict:
    """One step of ``arch``'s smoke config on ``device``: {"loss",
    "grad_norm", "grads", "params"} (numpy leaves in JAX order)."""
    params, batch, loss_fn = _case(arch, seed)
    params = tree.map(lambda t: t.to(device), params)
    opt_name = registry.get(arch).OPTIMIZER
    kw = {"stochastic_rounding": False} if opt_name == "adafactor" else {}
    opt = OPTIMIZERS[opt_name](lr=LR, warmup=1, **kw)
    _, grads = st.value_and_grad(loss_fn)(params, batch)
    state, metrics = st.make_train_step(loss_fn, opt)(
        {"params": params, "opt": opt.init(params)}, batch)
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "grads": [to_numpy(g) for g in tree.leaves(grads)],
            "params": [to_numpy(p) for p in tree.leaves(state["params"])]}


def assert_steps_agree(ref: dict, got: dict, what: str,
                       lr: float = LR) -> dict:
    """Raise unless ``got`` agrees with ``ref`` (module docstring; ``lr``
    the step's learning rate); return the largest errors {loss,
    grad_norm, grads, params}."""
    if len(ref["grads"]) != len(got["grads"]):
        raise AssertionError(f"{what}: leaf counts differ")
    errs = {}
    for k in ("loss", "grad_norm"):
        errs[k] = abs(got[k] - ref[k])
        if errs[k] > LOSS_RTOL * abs(ref[k]):
            raise AssertionError(f"{what}: {k} {got[k]} != {ref[k]}")
    errs["grads"] = errs["params"] = 0.0
    for i, (g_ref, g, p_ref, p) in enumerate(zip(
            ref["grads"], got["grads"], ref["params"], got["params"])):
        tol = G_ATOL + G_RTOL * float(np.abs(g_ref).max(initial=0.0))
        e = float(np.abs(g - g_ref).max(initial=0.0))
        if e > tol:
            raise AssertionError(f"{what}: gradient leaf {i} off by {e} "
                                 f"(tolerance {tol})")
        signless = np.abs(g_ref) <= tol
        dp = np.abs(p - p_ref)
        if (dp[~signless] > P_ATOL).any() or \
                (dp[signless] > 2 * lr * (1 + 1e-5)).any():
            raise AssertionError(f"{what}: parameter leaf {i} off by "
                                 f"{float(dp.max())}")
        errs["grads"] = max(errs["grads"], e)
        errs["params"] = max(errs["params"],
                             float(dp[~signless].max(initial=0.0)))
    return errs
