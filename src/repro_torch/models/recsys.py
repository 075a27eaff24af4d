"""RecSys models of the port: DLRM-RM2, xDeepFM, SASRec and BERT4Rec.

The port of ``repro.models.recsys``.  The shared substrate of DLRM and
xDeepFM is a multi-field EmbeddingBag, ``field_pool``, with the JAX
package's two branches.  The kernel branch (``use_kernel=True``, what
serving takes) flattens the F per-field tables into one (F*V, D) view (no
copy) with offset ids and pools every (row, field) bag in one
``embedding_bag`` launch.  The gather branch (``use_kernel=False``, what
training takes, as in the JAX package) gathers each field's rows, zeroes
the pads and pools them in plain ``torch``: autograd gives the tables'
gradient, which the kernel has not (it refuses a table that requires a
gradient).  The JAX gather clamps ids >= V inside each field's table;
both branches of the port clamp the same way (ids >= V are outside the
contract: ``CTRStream`` draws them ``% vocab``).

Each forward is the pool followed by a pure function of the pooled
embeddings (``dlrm_interact``, ``xdeepfm_interact``), so a caller can feed
the interaction pooled rows from elsewhere (``chip_smoke.py`` feeds it the
plain version's).  A DLRM forward is one embedding-bag launch; an xDeepFM
forward two (the field tables, then the order-1 linear term, which the JAX
package pools through its gather branch; the port pools it in the branch
the forward is given).

SASRec (causal) and BERT4Rec (bidirectional) share ``seqrec_encode``:
item and position embeddings, pre-norm self-attention blocks with a ReLU
FFN, a final RMSNorm.  As in the JAX package, a pad (-1) has its item
embedding zeroed but keeps its position embedding and stays an attention
key; only the output zeroes it.  The encode runs in row chunks of
``encode_rows(cfg)`` rows (rows are independent), so a 262,144-row batch
never holds its (B, H, S, S) scores at once.  Under autograd each chunk is
checkpointed (``torch.utils.checkpoint``: only its rows are kept, the
chunk is encoded again in the backward), so a train batch of 65,536
BERT4Rec rows never holds every chunk's saved activations at once.

Retrieval is the paper's index scan: ``candidate_index`` puts an item
table behind a ``MetricIndex`` (rows as they are, ids = row positions, -1
from ``n_valid`` on), whose search runs the fused kNN kernels on the card
(``knn_score`` + ``knn_select``): the body of the JAX package's
``make_batched_scorer``, the stable top-k of ``q @ table.T``.

The matrix products are plain ``torch`` calls (XLA's in the JAX package);
they are float32 and expect TF32 off (PyTorch's default for matmul).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.core import layout
from repro_torch.core.cache_ops import pad_features
from repro_torch.core.metric_index import MetricIndex
from repro_torch.dist.api import constrain, is_dtensor
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.models import common as cm

__all__ = ["flatten_fields", "field_pool", "DLRMConfig", "dlrm_init",
           "dlrm_interact", "dlrm_forward", "dlrm_user_tower",
           "XDeepFMConfig", "xdeepfm_init", "xdeepfm_interact",
           "xdeepfm_forward", "xdeepfm_user_tower", "SeqRecConfig",
           "seqrec_init", "encode_rows", "seqrec_encode",
           "seqrec_session_repr", "seqrec_score_candidates",
           "seqrec_bce_loss", "candidate_index", "DLRM", "XDeepFM",
           "SeqRec"]

INT32_MAX = 2 ** 31 - 1
# bytes of one encode chunk's largest per-row f32 intermediates (the
# attention scores and the FFN's hidden layer): what sets ``encode_rows``
ENCODE_BUDGET = 4 << 30


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


def field_pool(tables: torch.Tensor, idx: torch.Tensor, mode: str = "sum",
               use_kernel: bool = True) -> torch.Tensor:
    """tables (F, V, D) stacked per-field tables; idx (B, F, L) multi-hot
    ids (< 0 padding) -> (B, F, D) pooled per field.  ``use_kernel``: in
    one ``embedding_bag`` launch (f32 out); else the JAX package's gather
    branch (the tables' dtype, differentiable)."""
    f, v, d = tables.shape
    if use_kernel:
        out = embedding_bag(*flatten_fields(tables, idx), mode=mode)
        return out.view(idx.shape[0], f, d)
    if idx.shape[1] != f:
        raise ValueError(f"{f} tables for {idx.shape[1]} id fields")
    valid = idx >= 0
    safe = torch.where(valid, idx.clamp(max=v - 1), 0).long()
    field = torch.arange(f, device=idx.device)[None, :, None]
    rows = tables[field, safe] * valid[..., None]           # (B, F, L, D)
    if mode == "mean":
        cnt = valid.sum(dim=-1, keepdim=True).clamp(min=1)
        return rows.sum(dim=2) / cnt
    if mode == "max":
        out = torch.where(valid[..., None], rows, -torch.inf).amax(dim=2)
        return torch.where(torch.isfinite(out), out, 0.0)
    if mode != "sum":
        raise ValueError(f"mode {mode!r} not in ('sum', 'mean', 'max')")
    return rows.sum(dim=2)


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
            # out of place: a DTensor product may be a pending sum
            x = torch.relu(x)
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
                 cfg: DLRMConfig, use_kernel: bool = True) -> torch.Tensor:
    """dense (B, 13); sparse_idx (B, 26, L). Returns (B,) logits.
    ``use_kernel`` False pools through the gather branch (training)."""
    emb = field_pool(params["tables"], sparse_idx, use_kernel=use_kernel)
    return dlrm_interact(params, dense, constrain(emb, "act_bfd"), cfg)


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
                    cfg: XDeepFMConfig,
                    use_kernel: bool = True) -> torch.Tensor:
    """sparse_idx (B, 39, L). Returns (B,) logits (pre-sigmoid).
    ``use_kernel`` False pools through the gather branch (training)."""
    x0, lin = (field_pool(params[k], sparse_idx, use_kernel=use_kernel)
               for k in ("tables", "linear"))
    return xdeepfm_interact(params, constrain(x0, "act_bfd"), lin, cfg)


def xdeepfm_user_tower(params: dict, sparse_idx: torch.Tensor,
                       cfg: XDeepFMConfig) -> torch.Tensor:
    """Two-tower retrieval adaptation (mean field embedding)."""
    return field_pool(params["tables"], sparse_idx).mean(dim=1)


# ------------------------------------------- sequential models (shared)

@dataclasses.dataclass(frozen=True)
class SeqRecConfig:
    name: str = "sasrec"
    vocab: int = 1_000_000
    max_len: int = 50
    embed_dim: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    causal: bool = True          # SASRec causal; BERT4Rec bidirectional
    d_ff_mult: int = 4
    dtype: torch.dtype = torch.float32


def seqrec_init(cfg: SeqRecConfig, *, device=None, generator=None) -> dict:
    """The JAX package's distributions (not its values) drawn from
    ``generator`` on ``device``."""
    dev = resolve_device(device)
    kw = dict(dtype=cfg.dtype, device=dev, generator=generator)
    d = cfg.embed_dim

    def ones():
        return torch.ones((d,), dtype=torch.float32, device=dev)

    p = {"item_emb": _normal((cfg.vocab, d), d ** -0.5, **kw),
         "pos_emb": _normal((cfg.max_len, d), 0.02, **kw),
         "blocks": [],
         "final_norm": ones()}
    for _ in range(cfg.n_blocks):
        p["blocks"].append({
            **{w: _normal((d, d), d ** -0.5, **kw)
               for w in ("wq", "wk", "wv", "wo")},
            "ffn": _mlp_init([d, cfg.d_ff_mult * d, d], **kw),
            "norm1": ones(), "norm2": ones()})
    return p


def encode_rows(cfg: SeqRecConfig) -> int:
    """Rows of one encode chunk: the largest power of two whose attention
    scores (H x S x S) and FFN hidden layer (S x d_ff) in f32 fit
    ``ENCODE_BUDGET`` (SASRec 65,536 rows, BERT4Rec 4,096)."""
    s = cfg.max_len
    row = 4 * s * (cfg.n_heads * s + cfg.d_ff_mult * cfg.embed_dim)
    return 1 << (max(ENCODE_BUDGET // row, 1).bit_length() - 1)


def _by_rows(fn, items: torch.Tensor, rows: int) -> torch.Tensor:
    """``fn`` over row chunks of ``items``, written into one output."""
    b = items.shape[0]
    if b <= rows:
        return fn(items)
    first = fn(items[:rows])
    out = first.new_empty((b,) + tuple(first.shape[1:]))
    out[:rows] = first
    for lo in range(rows, b, rows):
        out[lo:lo + rows] = fn(items[lo:lo + rows])
    return out


def _rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[max(ids, 0)]``, as the JAX package gathers (pads read row
    0, masked by the caller).  Through ``F.embedding``, whose backward
    sums the rows of each id in parallel: a quarter of a train batch's
    positions are pads, all reading row 0, and indexing's backward
    (``index_put_`` with accumulate) adds such a run one row at a time
    (1.15 s of a 1.36 s SASRec step at 65,536 rows on the H100).  A
    ``DTensor`` table is indexed: DTensor's vocab-parallel embedding keeps
    one mask a gather, which a second use of the rows (the backward)
    finds spent."""
    ids = ids.clamp(min=0).long()
    if is_dtensor(table):
        return table[ids]
    return torch.nn.functional.embedding(ids, table)


def _encode(params: dict, items: torch.Tensor, cfg: SeqRecConfig):
    """``seqrec_encode`` of one chunk of rows."""
    b, s = items.shape
    d, h = cfg.embed_dim, cfg.n_heads
    mask = (items >= 0)[..., None]
    x = _rows(params["item_emb"], items) * mask
    x = constrain(x + params["pos_emb"][None, :s], "act_bsd")
    chunk, masks = min(256, s), {}
    for blk in params["blocks"]:
        xn = cm.rms_norm(x, blk["norm1"])
        q, k, v = ((xn @ blk[w]).reshape(b, s, h, d // h)
                   for w in ("wq", "wk", "wv"))
        o = cm.blockwise_attention(q, k, v, causal=cfg.causal,
                                   q_chunk=chunk, kv_chunk=chunk,
                                   masks=masks)
        x = x + o.reshape(b, s, d) @ blk["wo"]
        xn = cm.rms_norm(x, blk["norm2"])
        x = x + _mlp(blk["ffn"], xn.reshape(b * s, d)).reshape(b, s, d)
    x = cm.rms_norm(x, params["final_norm"])
    return x * mask


def _records(params: dict) -> bool:
    """True when autograd records a graph over ``params``."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in params.values()
        if isinstance(t, torch.Tensor))


def seqrec_encode(params: dict, items: torch.Tensor,
                  cfg: SeqRecConfig) -> torch.Tensor:
    """items (B, S) int32, -1 = pad.  Returns (B, S, D) hidden states,
    encoded ``encode_rows(cfg)`` rows at a time (each chunk checkpointed
    under autograd)."""
    if _records(params):
        return _by_rows(lambda it: ckpt.checkpoint(
            _encode, params, it, cfg, use_reentrant=False), items,
            encode_rows(cfg))
    return _by_rows(lambda it: _encode(params, it, cfg), items,
                    encode_rows(cfg))


def _last(hidden: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """The hidden state at position max(count of items - 1, 0) of each
    row, as the JAX package reads it (an all-pad row reads position 0)."""
    pos = ((items >= 0).sum(dim=1) - 1).clamp(min=0)
    return hidden[torch.arange(items.shape[0], device=items.device), pos]


def seqrec_session_repr(params: dict, items: torch.Tensor,
                        cfg: SeqRecConfig) -> torch.Tensor:
    """The retrieval query (B, D): each row's last valid hidden state,
    chunk by chunk (no (B, S, D) hidden states held at once)."""
    return _by_rows(lambda it: _last(_encode(params, it, cfg), it), items,
                    encode_rows(cfg))


def seqrec_score_candidates(params: dict, session: torch.Tensor,
                            cand_ids: Optional[torch.Tensor] = None):
    """Inner products (B, C) of ``session`` (B, D) with the item table's
    rows ``cand_ids`` (C,) (None: the whole vocab)."""
    table = params["item_emb"]
    if cand_ids is not None:
        table = table[torch.as_tensor(cand_ids, device=table.device).long()]
    return session @ table.T


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """log(sigmoid(x)) = min(x, 0) - log1p(exp(-|x|)), from pointwise ops
    that a ``DTensor`` differentiates (it has no rule for
    ``log_sigmoid_backward``)."""
    return torch.clamp(x, max=0) - torch.log1p(torch.exp(-torch.abs(x)))


def seqrec_bce_loss(params: dict, items: torch.Tensor, pos: torch.Tensor,
                    neg: torch.Tensor, cfg: SeqRecConfig) -> torch.Tensor:
    """SASRec-style BCE, one positive and one sampled negative per
    position (items / pos / neg (B, S), -1 pads): the forward value."""
    hidden = seqrec_encode(params, items, cfg)
    valid = pos >= 0
    emb = params["item_emb"]
    s_pos = (hidden * _rows(emb, pos)).sum(dim=-1)
    s_neg = (hidden * _rows(emb, neg)).sum(dim=-1)
    loss = -(_log_sigmoid(s_pos) + _log_sigmoid(-s_neg))
    return (loss * valid).sum() / valid.sum().clamp(min=1)


def candidate_index(table: torch.Tensor, n_valid: Optional[int] = None, *,
                    dim: Optional[int] = None, device=None) -> MetricIndex:
    """The paper's index scan over an item table (V, width): a
    ``MetricIndex`` of its rows as they are (fp32, whatever
    ``REPRO_CORPUS_DTYPE`` says), ids = row positions, -1 on the rows at and
    past ``n_valid``, which never win.  Its ``search(q, k)`` is the stable
    top-k of ``q @ table.T``.  A table already at ``layout.phys_dim``
    width on ``device`` is used as is, not copied; ``dim`` names the
    logical width of a table that arrives zero-padded."""
    dev = resolve_device(device)
    ids = torch.arange(table.shape[0], dtype=torch.int32, device=dev)
    if n_valid is not None:
        ids[n_valid:] = -1
    return MetricIndex(table, ids, transformed=True, dtype="fp32", dim=dim,
                       device=dev)


# --------------------------------------------------------------- modules

def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class _Node(nn.Module):
    """A dict of subtrees that are not all tensors (a seqrec block)."""

    def __init__(self, tree: dict):
        super().__init__()
        self._keys = tuple(tree)
        for k, v in tree.items():
            setattr(self, k, _hold(v))


def _hold(v):
    if isinstance(v, torch.Tensor):
        return _frozen(v)
    if isinstance(v, dict):
        if all(isinstance(x, torch.Tensor) for x in v.values()):
            return nn.ParameterDict({k: _frozen(x) for k, x in v.items()})
        return _Node(v)
    if all(isinstance(x, torch.Tensor) for x in v):
        return nn.ParameterList([_frozen(x) for x in v])
    return nn.ModuleList([_hold(x) for x in v])


def _tree(v):
    if isinstance(v, nn.ParameterList):
        return list(v)
    if isinstance(v, nn.ModuleList):
        return [_tree(x) for x in v]
    if isinstance(v, nn.ParameterDict):
        return dict(v.items())
    if isinstance(v, _Node):
        return {k: _tree(getattr(v, k)) for k in v._keys}
    return v


class _Recsys(nn.Module):
    """A parameter tree held as frozen parameters on one device: the
    modules serve these models through the kernel branch (the kernel has
    no backward, as in the JAX package; training takes the functions and
    the gather branch, ``train.step``).  ``params`` rebuilds the tree the
    functions take."""

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
        return torch.as_tensor(x, device=next(self.parameters()).device)


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


class SeqRec(_Recsys):
    """SASRec or BERT4Rec on one device; ``device=None`` means the card.

    ``retrieve(items, k, n_valid)`` answers each session with the top-k
    items of the paper's index scan over its own item table
    (``candidate_index``: the kNN kernels on the card).  The index is built
    once per ``n_valid`` and shares one payload: the table itself at a
    width of ``layout.phys_dim`` (BERT4Rec's 64), else one zero-padded copy
    (SASRec's 50 -> 64, 268 MB at full width)."""

    def __init__(self, cfg: SeqRecConfig, *, device=None, generator=None):
        super().__init__(cfg, seqrec_init(cfg, device=device,
                                          generator=generator))
        self._indexes: dict = {}

    def _apply(self, fn, *args, **kwargs):
        self._indexes.clear()       # a move or a cast leaves them stale
        return super()._apply(fn, *args, **kwargs)

    def encode(self, items) -> torch.Tensor:
        return seqrec_encode(self.params, self._put(items), self.cfg)

    def session_repr(self, items) -> torch.Tensor:
        return seqrec_session_repr(self.params, self._put(items), self.cfg)

    def score_candidates(self, session, cand_ids=None) -> torch.Tensor:
        return seqrec_score_candidates(self.params, self._put(session),
                                       cand_ids)

    def bce_loss(self, items, pos, neg) -> torch.Tensor:
        return seqrec_bce_loss(self.params, self._put(items), self._put(pos),
                               self._put(neg), self.cfg)

    def index(self, n_valid: Optional[int] = None) -> MetricIndex:
        """The candidate index over the item table (memoized)."""
        if n_valid not in self._indexes:
            d = self.cfg.embed_dim
            payload = next((ix.doc_emb for ix in self._indexes.values()),
                           None)
            if payload is None:
                payload = pad_features(self.item_emb.detach(),
                                       layout.phys_dim(d))
            self._indexes[n_valid] = candidate_index(
                payload, n_valid, dim=d, device=payload.device)
        return self._indexes[n_valid]

    def retrieve(self, items, k: int, n_valid: Optional[int] = None):
        """(scores (B, k) descending, ids (B, k) item rows) of each
        session's top-k items."""
        res = self.index(n_valid).search(self.session_repr(items), k)
        return res.scores, res.ids
