"""Config-driven LM transformer: the dense GQA forward.

The port of ``repro.models.transformer``'s dense path, which the query
encoder (``repro_torch.serve.engine.make_lm_query_encoder``) runs:

  * GQA attention (chatglm3 kv=2, mistral kv=8, gemma2 kv=8, STAR kv=H)
    through ``models.common.blockwise_attention``;
  * RoPE (full, chatglm's interleaved half), per-layer local / global
    window schedules, attention and final logit softcaps, pre + post and
    zero-centred RMSNorms (gemma2), scaled embeddings, tied or untied head;
  * a SwiGLU FFN.

Parameters keep the JAX package's tree: ``embed`` (V, D), ``final_norm``,
``lm_head`` (D, V) when untied, and the layers stacked in
``group0_dense`` with a leading layer axis, weights (d_in, d_out) for
``x @ w``.  Carrying JAX weights across is a copy of arrays
(``repro_torch.convert.transformer_params_from_numpy``).  ``forward``
loops over the stacked layers and indexes each layer's slice (a view, no
copy): the JAX package's ``lax.scan``.  ``remat`` is a training concept
and is not carried over.

``hidden_states`` is the forward without the head: an encoder pools the
hidden states and never needs logits (under ``jax.jit`` XLA drops the
unused head; an eager head would cost the STAR encoder 2 x 4,096 x 768 x
30,522 operations and a 500 MB output at 64 x 64 tokens).

Not ported yet, and raising ``NotImplementedError`` with their ROADMAP
item: MLA attention and MoE layers (with MTP), the decode path
(``return_kv``, ``init_kv_caches``, ``decode_step``).

The matrix products are plain ``torch`` calls (XLA's in the JAX package):
float32 configs expect TF32 off, PyTorch's default for matmul.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import common as cm

__all__ = ["MLAConfig", "TransformerConfig", "init_params", "param_count",
           "hidden_states", "forward", "init_kv_caches", "decode_step",
           "Transformer"]

_MLA_MOE = "ROADMAP.md queue 1, item 13a (MLA and MoE)"
_DECODE = "ROADMAP.md queue 1, item 13b (the decode path)"


# --------------------------------------------------------------- configs

@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None
    attention: str = "gqa"                  # "gqa" | "mla"
    mla: Optional[MLAConfig] = None
    rope_theta: float = 1e4
    rotary_frac: float = 1.0                # 0.5 => chatglm partial rotary
    rope_interleaved: bool = False
    window: Optional[int] = None
    layer_pattern: Optional[str] = None     # cycled, e.g. "lg" (gemma2)
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    moe: Optional[Any] = None               # the JAX MoEConfig (item 13a)
    n_dense_layers: int = 0                 # leading dense layers when MoE
    mtp: bool = False                       # deepseek multi-token prediction
    mtp_weight: float = 0.3
    norm_eps: float = 1e-6
    use_post_norm: bool = False             # gemma2 pre+post norms
    zero_centered_norm: bool = False        # gemma-style (1 + w)
    embed_scale: bool = False               # multiply embeddings by sqrt(d)
    tie_embeddings: bool = True
    dtype: torch.dtype = torch.bfloat16
    q_chunk: int = 512
    kv_chunk: int = 1024

    @property
    def head_dim(self) -> int:
        if self.attention == "mla":
            m = self.mla or MLAConfig()
            return m.qk_nope_dim + m.qk_rope_dim
        return self.d_head or self.d_model // self.n_heads

    @property
    def v_head_dim(self) -> int:
        if self.attention == "mla":
            return (self.mla or MLAConfig()).v_head_dim
        return self.d_head or self.d_model // self.n_heads

    def layer_groups(self):
        """[(kind, count)] — dense-prefix then MoE remainder."""
        if self.moe is None:
            return [("dense", self.n_layers)]
        nd = self.n_dense_layers
        out = []
        if nd:
            out.append(("dense", nd))
        out.append(("moe", self.n_layers - nd))
        return out

    def window_schedule(self) -> tuple:
        """Per-layer window sizes as Python ints; 0 = unlimited (global)."""
        if self.layer_pattern is None:
            return (self.window or 0,) * self.n_layers
        pat = (self.layer_pattern * self.n_layers)[: self.n_layers]
        return tuple((self.window or 0) if c == "l" else 0 for c in pat)


def _dense_only(cfg: TransformerConfig) -> None:
    if cfg.attention == "mla" or cfg.moe is not None or cfg.mtp:
        raise NotImplementedError(f"{cfg.name}: MLA / MoE / MTP are not "
                                  f"ported yet: {_MLA_MOE}")


# ------------------------------------------------------------ param init

def _normal(shape, scale, *, dtype, device, generator):
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=device).mul_(scale)


def _norm_init(cfg: TransformerConfig, shape, device) -> torch.Tensor:
    fill = torch.zeros if cfg.zero_centered_norm else torch.ones
    return fill(shape, dtype=torch.float32, device=device)


def _init_layers(cfg: TransformerConfig, count: int, kw: dict) -> dict:
    """``count`` dense layers stacked on a leading axis (the JAX package
    vmaps ``_init_layer``): its distributions, not its values."""
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    L, dev = count, kw["device"]
    p = {
        "attn": {
            "wq": _normal((L, d, h * dh), d ** -0.5, **kw),
            "wk": _normal((L, d, kv * dh), d ** -0.5, **kw),
            "wv": _normal((L, d, kv * dh), d ** -0.5, **kw),
            "wo": _normal((L, h * dh, d),
                          (h * dh) ** -0.5 / (2 * cfg.n_layers) ** 0.5, **kw),
        },
        "pre_attn_norm": _norm_init(cfg, (L, d), dev),
        "pre_ffn_norm": _norm_init(cfg, (L, d), dev),
    }
    if cfg.use_post_norm:
        p["post_attn_norm"] = _norm_init(cfg, (L, d), dev)
        p["post_ffn_norm"] = _norm_init(cfg, (L, d), dev)
    p["ffn"] = {
        "wi": _normal((L, d, 2 * cfg.d_ff), d ** -0.5, **kw),
        "wo": _normal((L, cfg.d_ff, d),
                      cfg.d_ff ** -0.5 / (2 * cfg.n_layers) ** 0.5, **kw),
    }
    return p


def init_params(cfg: TransformerConfig, *, device=None,
                generator: Optional[torch.Generator] = None) -> dict:
    """The JAX package's tree, shapes and scales (not its values), drawn
    from ``generator`` on ``device`` (None means ``cuda``)."""
    _dense_only(cfg)
    dev = resolve_device(device)
    kw = dict(dtype=cfg.dtype, device=dev, generator=generator)
    params = {
        "embed": _normal((cfg.vocab_size, cfg.d_model), 0.02, **kw),
        "final_norm": _norm_init(cfg, (cfg.d_model,), dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal((cfg.d_model, cfg.vocab_size),
                                    cfg.d_model ** -0.5, **kw)
    for gi, (kind, count) in enumerate(cfg.layer_groups()):
        params[f"group{gi}_{kind}"] = _init_layers(cfg, count, kw)
    return params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def param_count(params) -> int:
    return sum(int(x.numel()) for x in _leaves(params))


def _layer(stack: dict, i: int) -> dict:
    """Layer ``i`` of a stacked group: views, no copy."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stack.items()}


# ------------------------------------------------------------- attention

def _attn_gqa(p: dict, x: torch.Tensor, rope, window: int,
              cfg: TransformerConfig, masks: dict) -> torch.Tensor:
    """Causal GQA self-attention of one layer (the JAX ``_attn_gqa``
    without its KV-cache branch); ``rope`` is the forward's (cos, sin)."""
    b, s, _d = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).view(b, s, h, dh)
    k = (x @ p["wk"]).view(b, s, kv, dh)
    v = (x @ p["wv"]).view(b, s, kv, dh)
    q = cm.rotate(q, *rope, cfg.rope_interleaved)
    k = cm.rotate(k, *rope, cfg.rope_interleaved)
    o = cm.blockwise_attention(q, k, v, causal=True, window=window,
                               q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                               logit_cap=cfg.attn_softcap, masks=masks)
    return o.reshape(b, s, h * dh) @ p["wo"]


# ----------------------------------------------------------------- block

def _dense_ffn(p: dict, x: torch.Tensor) -> torch.Tensor:
    gate, up = (x @ p["wi"]).chunk(2, dim=-1)
    return (torch.nn.functional.silu(gate) * up) @ p["wo"]


def _block(p: dict, x: torch.Tensor, rope, window: int,
           cfg: TransformerConfig, masks: dict) -> torch.Tensor:
    def norm(t, scale):
        return cm.rms_norm(t, scale, cfg.norm_eps, cfg.zero_centered_norm)

    a_out = _attn_gqa(p["attn"], norm(x, p["pre_attn_norm"]), rope, window,
                      cfg, masks)
    if cfg.use_post_norm:
        a_out = norm(a_out, p["post_attn_norm"])
    x = x + a_out
    f_out = _dense_ffn(p["ffn"], norm(x, p["pre_ffn_norm"]))
    if cfg.use_post_norm:
        f_out = norm(f_out, p["post_ffn_norm"])
    return x + f_out


# --------------------------------------------------------------- forward

def hidden_states(params: dict, tokens: torch.Tensor,
                  cfg: TransformerConfig) -> torch.Tensor:
    """Final-normed hidden states (B, S, D) of a causal forward over
    ``tokens`` (B, S) on the parameters' device.

    The embedding lookup is tensor indexing, as ``params["embed"][tokens]``
    is in JAX: a pad id of -1 reads the LAST row in both (where
    ``F.embedding`` would raise).  With right padding, causal attention
    keeps pads out of every real position.
    """
    _dense_only(cfg)
    embed = params["embed"]
    tokens = torch.as_tensor(tokens, device=embed.device)
    b, s = tokens.shape
    x = embed[tokens].to(cfg.dtype)
    if cfg.embed_scale:
        # sqrt(d) rounded to the model's dtype first, as JAX's
        # jnp.asarray(d ** 0.5, cfg.dtype); a host scalar, no copy to the card
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype).item()
    positions = torch.arange(s, device=x.device)
    rope = cm.rope_angles(positions, cfg.head_dim, cfg.rope_theta,
                          cfg.rotary_frac)
    windows = cfg.window_schedule()
    masks: dict = {}
    base = 0
    for gi, (kind, count) in enumerate(cfg.layer_groups()):
        stack = params[f"group{gi}_{kind}"]
        for i in range(count):
            x = _block(_layer(stack, i), x, rope, windows[base + i], cfg,
                       masks)
        base += count
    return cm.rms_norm(x, params["final_norm"], cfg.norm_eps,
                       zero_centered=cfg.zero_centered_norm)


def _head(params: dict, hidden: torch.Tensor,
          cfg: TransformerConfig) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return cm.softcap(hidden @ w.to(cfg.dtype), cfg.final_softcap)


def forward(params: dict, tokens: torch.Tensor, cfg: TransformerConfig, *,
            return_kv: bool = False):
    """Causal forward pass (prefill): ``hidden_states`` then the head.

    Returns (logits, aux_loss, hidden, None) as the JAX package does; the
    aux loss of a dense model is 0.
    """
    if return_kv:
        raise NotImplementedError(f"return_kv is not ported yet: {_DECODE}")
    hidden = hidden_states(params, tokens, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=hidden.device)
    return _head(params, hidden, cfg), aux, hidden, None


def init_kv_caches(cfg: TransformerConfig, batch: int, max_len: int):
    raise NotImplementedError(f"init_kv_caches is not ported yet: {_DECODE}")


def decode_step(params: dict, token, caches, cur_len,
                cfg: TransformerConfig):
    raise NotImplementedError(f"decode_step is not ported yet: {_DECODE}")


# ---------------------------------------------------------------- module

def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


class Transformer(nn.Module):
    """A dense transformer on one device, its parameters held frozen
    (``device=None`` means the card): ``params`` (the JAX package's tree,
    e.g. from ``convert.transformer_params_from_numpy``) moved there, else
    ``init_params`` drawn from ``generator``.  ``params`` rebuilds the tree
    the functions take."""

    def __init__(self, cfg: TransformerConfig, params: Optional[dict] = None,
                 *, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if params is None:
            params = init_params(cfg, device=dev, generator=generator)
        self.cfg = cfg
        self._paths = []
        for path, leaf in _flatten(params):
            self.register_parameter("__".join(path), nn.Parameter(
                torch.as_tensor(leaf, device=dev), requires_grad=False))
            self._paths.append(path)

    @property
    def params(self) -> dict:
        tree: dict = {}
        for path in self._paths:
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = getattr(self, "__".join(path))
        return tree

    def hidden_states(self, tokens) -> torch.Tensor:
        return hidden_states(self.params, tokens, self.cfg)

    def forward(self, tokens) -> torch.Tensor:
        """Logits (B, S, V)."""
        return forward(self.params, tokens, self.cfg)[0]
