"""RecSys serving models of the port: DLRM-RM2 and xDeepFM.

The port of the DLRM and xDeepFM part of ``repro.models.recsys``.  The
shared substrate is a multi-field EmbeddingBag: ``field_pool`` flattens the
F per-field tables into one (F*V, D) view (no copy) with offset ids and
pools every (row, field) bag in one ``embedding_bag`` launch -- the JAX
package's kernel branch.  Its gather branch clamps ids >= V inside each
field's table; the port clamps the same way before offsetting, so both
branches agree with it on every id (ids >= V are outside the contract:
``CTRStream`` draws them ``% vocab``).

Each forward is the pool followed by a pure function of the pooled
embeddings (``dlrm_interact``, ``xdeepfm_interact``), so a caller can feed
the interaction pooled rows from elsewhere (``chip_smoke.py`` feeds it the
plain version's).  A DLRM forward is one embedding-bag launch; an xDeepFM
forward two (the field tables, then the order-1 linear term, which the JAX
package pools through its gather branch).

The matrix products are plain ``torch`` calls (XLA's in the JAX package);
they are float32 and expect TF32 off (PyTorch's default for matmul).
The SASRec / BERT4Rec part is not ported yet (ROADMAP, queue 1).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.kernels.embedding_bag.ops import embedding_bag

__all__ = ["flatten_fields", "field_pool", "DLRMConfig", "dlrm_init",
           "dlrm_interact", "dlrm_forward", "dlrm_user_tower",
           "XDeepFMConfig", "xdeepfm_init", "xdeepfm_interact",
           "xdeepfm_forward", "xdeepfm_user_tower", "DLRM", "XDeepFM"]

INT32_MAX = 2 ** 31 - 1


# ------------------------------------------------------------ embeddings

def flatten_fields(tables: torch.Tensor, idx: torch.Tensor):
    """(the (F*V, D) view of ``tables`` (F, V, D), the (B*F, L) int32 flat
    ids of ``idx`` (B, F, L)): id + f*V per field, ids >= V clamped to V - 1
    within their field, padding (< 0) kept as -1."""
    f, v, d = tables.shape
    b, f2, l = idx.shape
    if f != f2:
        raise ValueError(f"{f} tables for {f2} id fields")
    if f * v > INT32_MAX:
        raise ValueError(f"{f} x {v} rows do not fit int32 flat ids")
    idx = idx.to(torch.int32)
    offset = (torch.arange(f, dtype=torch.int32, device=idx.device)
              * v)[None, :, None]
    flat_idx = torch.where(idx >= 0, idx.clamp(max=v - 1) + offset, -1)
    return tables.view(f * v, d), flat_idx.reshape(b * f, l)


def field_pool(tables: torch.Tensor, idx: torch.Tensor,
               mode: str = "sum") -> torch.Tensor:
    """tables (F, V, D) stacked per-field tables; idx (B, F, L) multi-hot
    ids (< 0 padding) -> (B, F, D) f32 pooled per field, in one launch."""
    f, _, d = tables.shape
    out = embedding_bag(*flatten_fields(tables, idx), mode=mode)
    return out.view(idx.shape[0], f, d)


def _normal(shape, scale, *, dtype, device, generator):
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=device).mul_(scale)


def _mlp_init(sizes, **kw):
    return [{"w": _normal((a, b), (2.0 / a) ** 0.5, **kw),
             "b": torch.zeros((b,), dtype=kw["dtype"], device=kw["device"])}
            for a, b in zip(sizes[:-1], sizes[1:])]


def _mlp(layers, x, final_act=False):
    for i, layer in enumerate(layers):
        x = torch.addmm(layer["b"], x, layer["w"])          # x @ w + b
        if i < len(layers) - 1 or final_act:
            x = torch.relu_(x)
    return x


# ------------------------------------------------------------------ DLRM

@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-rm2"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    vocab: int = 1_000_000
    multi_hot: int = 1
    bot_mlp: tuple = (13, 512, 256, 64)
    top_mlp_hidden: tuple = (512, 512, 256, 1)
    dtype: torch.dtype = torch.float32


def dlrm_init(cfg: DLRMConfig, *, device=None, generator=None) -> dict:
    """The JAX package's distributions (not its values) drawn from
    ``generator`` on ``device``."""
    kw = dict(dtype=cfg.dtype, device=resolve_device(device),
              generator=generator)
    n_pairs = (cfg.n_sparse + 1) * cfg.n_sparse // 2
    return {
        "tables": _normal((cfg.n_sparse, cfg.vocab, cfg.embed_dim),
                          cfg.embed_dim ** -0.5, **kw),
        "bot": _mlp_init(list(cfg.bot_mlp), **kw),
        "top": _mlp_init([cfg.embed_dim + n_pairs]
                         + list(cfg.top_mlp_hidden), **kw),
    }


def dlrm_interact(params: dict, dense: torch.Tensor, emb: torch.Tensor,
                  cfg: DLRMConfig) -> torch.Tensor:
    """Bottom MLP, dot interaction (upper triangle of the 27 x 27 gram,
    row-major as ``jnp.triu_indices``) and top MLP over pooled ``emb``
    (B, 26, D).  Returns (B,) logits."""
    z0 = _mlp(params["bot"], dense.to(cfg.dtype), final_act=True)  # (B, D)
    feats = torch.cat([z0[:, None, :], emb], dim=1)                # (B, 27, D)
    gram = torch.bmm(feats, feats.transpose(1, 2))
    f = feats.shape[1]
    iu, ju = torch.triu_indices(f, f, offset=1, device=feats.device)
    inter = gram[:, iu, ju]                                        # (B, 351)
    return _mlp(params["top"], torch.cat([z0, inter], dim=1))[:, 0]


def dlrm_forward(params: dict, dense: torch.Tensor, sparse_idx: torch.Tensor,
                 cfg: DLRMConfig) -> torch.Tensor:
    """dense (B, 13); sparse_idx (B, 26, L). Returns (B,) logits."""
    return dlrm_interact(params, dense, field_pool(params["tables"],
                                                   sparse_idx), cfg)


def dlrm_user_tower(params: dict, dense: torch.Tensor,
                    sparse_idx: torch.Tensor, cfg: DLRMConfig) -> torch.Tensor:
    """Two-tower retrieval adaptation: pooled user repr (B, D)."""
    z0 = _mlp(params["bot"], dense.to(cfg.dtype), final_act=True)
    return z0 + field_pool(params["tables"], sparse_idx).mean(dim=1)


# --------------------------------------------------------------- xDeepFM

@dataclasses.dataclass(frozen=True)
class XDeepFMConfig:
    name: str = "xdeepfm"
    n_sparse: int = 39
    embed_dim: int = 10
    vocab: int = 1_000_000
    cin_layers: tuple = (200, 200, 200)
    mlp: tuple = (400, 400)
    dtype: torch.dtype = torch.float32


def xdeepfm_init(cfg: XDeepFMConfig, *, device=None, generator=None) -> dict:
    """The JAX package's distributions (not its values) drawn from
    ``generator`` on ``device``."""
    kw = dict(dtype=cfg.dtype, device=resolve_device(device),
              generator=generator)
    m, d = cfg.n_sparse, cfg.embed_dim
    p = {"tables": _normal((m, cfg.vocab, d), d ** -0.5, **kw),
         "linear": _normal((m, cfg.vocab, 1), 0.01, **kw),
         "dnn": _mlp_init([m * d] + list(cfg.mlp) + [1], **kw),
         "cin": []}
    h_prev = m
    for h in cfg.cin_layers:
        p["cin"].append(_normal((h, h_prev * m), (h_prev * m) ** -0.5, **kw))
        h_prev = h
    p["cin_out"] = _normal((sum(cfg.cin_layers), 1), 0.1, **kw)
    return p


def xdeepfm_interact(params: dict, x0: torch.Tensor, lin: torch.Tensor,
                     cfg: XDeepFMConfig) -> torch.Tensor:
    """CIN, DNN and the order-1 term over pooled field embeddings ``x0``
    (B, m, D) and pooled linear weights ``lin`` (B, m, 1).  Returns (B,)
    logits (pre-sigmoid)."""
    b, m, d = x0.shape
    xk, pooled = x0, []
    for w in params["cin"]:
        # (B, Hk*m, D) with h major, as the JAX reshape of "bhd,bmd->bhmd"
        z = (xk[:, :, None, :] * x0[:, None, :, :]).reshape(b, -1, d)
        xk = torch.matmul(w, z)                                    # (B, Hk+1, D)
        pooled.append(xk.sum(dim=-1))
    cin_logit = torch.cat(pooled, dim=1) @ params["cin_out"]       # (B, 1)
    dnn_logit = _mlp(params["dnn"], x0.reshape(b, m * d))
    return (cin_logit + dnn_logit)[:, 0] + lin.sum(dim=(1, 2))


def xdeepfm_forward(params: dict, sparse_idx: torch.Tensor,
                    cfg: XDeepFMConfig) -> torch.Tensor:
    """sparse_idx (B, 39, L). Returns (B,) logits (pre-sigmoid)."""
    x0 = field_pool(params["tables"], sparse_idx)
    lin = field_pool(params["linear"], sparse_idx)
    return xdeepfm_interact(params, x0, lin, cfg)


def xdeepfm_user_tower(params: dict, sparse_idx: torch.Tensor,
                       cfg: XDeepFMConfig) -> torch.Tensor:
    """Two-tower retrieval adaptation (mean field embedding)."""
    return field_pool(params["tables"], sparse_idx).mean(dim=1)


# --------------------------------------------------------------- modules

def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _hold(v):
    if isinstance(v, torch.Tensor):
        return _frozen(v)
    if all(isinstance(x, torch.Tensor) for x in v):
        return nn.ParameterList([_frozen(x) for x in v])
    return nn.ModuleList([nn.ParameterDict({k: _frozen(x)
                                            for k, x in layer.items()})
                          for layer in v])


def _tree(v):
    if isinstance(v, nn.ParameterList):
        return list(v)
    if isinstance(v, nn.ModuleList):
        return [dict(layer.items()) for layer in v]
    return v


class _Recsys(nn.Module):
    """A parameter tree held as frozen parameters on one device: the port
    serves these models (the kernel has no backward, as in the JAX
    package).  ``params`` rebuilds the tree the functions take."""

    def __init__(self, cfg, params: dict):
        super().__init__()
        self.cfg = cfg
        self._names = tuple(params)
        for name, v in params.items():
            setattr(self, name, _hold(v))

    @property
    def params(self) -> dict:
        return {n: _tree(getattr(self, n)) for n in self._names}

    def _put(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.tables.device)


class DLRM(_Recsys):
    """DLRM-RM2 on one device; ``device=None`` means the card."""

    def __init__(self, cfg: DLRMConfig, *, device=None, generator=None):
        super().__init__(cfg, dlrm_init(cfg, device=device,
                                        generator=generator))

    def forward(self, dense, sparse_idx) -> torch.Tensor:
        return dlrm_forward(self.params, self._put(dense),
                            self._put(sparse_idx), self.cfg)

    def user_tower(self, dense, sparse_idx) -> torch.Tensor:
        return dlrm_user_tower(self.params, self._put(dense),
                               self._put(sparse_idx), self.cfg)


class XDeepFM(_Recsys):
    """xDeepFM on one device; ``device=None`` means the card."""

    def __init__(self, cfg: XDeepFMConfig, *, device=None, generator=None):
        super().__init__(cfg, xdeepfm_init(cfg, device=device,
                                           generator=generator))

    def forward(self, sparse_idx) -> torch.Tensor:
        return xdeepfm_forward(self.params, self._put(sparse_idx), self.cfg)

    def user_tower(self, sparse_idx) -> torch.Tensor:
        return xdeepfm_user_tower(self.params, self._put(sparse_idx),
                                  self.cfg)
