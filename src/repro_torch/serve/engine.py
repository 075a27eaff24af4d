"""End-to-end conversational search engine (Fig. 2 of the paper).

The port of ``repro.serve.engine``.  Client side: a query encoder
(``make_lm_query_encoder``: any LM backbone of ``models.transformer``,
dense, MoE or MLA -> pooled, projected, Eq. 1-transformed embedding; or
none, when the caller hands in psi) and
one session's ``MetricCache``.  Server side: the sharded metric index
behind the straggler-hedging ``ShardedRouter``.  ``answer()`` is
Algorithm 1 with one resilience extension: a *degraded* back-end answer
(some shards timed out) still completes the turn, inserting its documents
without the (psi, r_a) record, and when the back end fails entirely a
non-empty cache answers (cache as fault tolerance).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import layout, quant
from repro_torch.core.cache import MetricCache
from repro_torch.core.cache_ops import CacheConfig
from repro_torch.core.embedding import transform_queries
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.serve.telemetry import ENCODER_GRAPHS, SPANS, sync_site

__all__ = ["make_lm_query_encoder", "graphable", "pad_length",
           "EngineTurn", "ConversationalEngine", "radius_and_docs",
           "radius_from_scores"]

_CAPTURE = SPANS.kind("serve.encoder_capture")
_CAPTURE_SYNC = sync_site("encoder_capture")


def make_lm_query_encoder(params: dict, cfg, proj, *,
                          device=None) -> Callable:
    """Mean-pooled final hidden states -> R^l -> Eq. 1 transform.

    ``params`` is a ``models.transformer`` tree (``Transformer.params``, or
    ``convert.transformer_params_from_numpy``'s), ``proj`` the (d_model, l)
    projection to the retrieval space; both are moved to ``device`` (None
    means ``cuda``) once.  ``encode(tokens)`` takes (B, S) token ids,
    right-padded with -1 (masked out of the pool; S up to ``cfg.q_chunk``,
    or a multiple of it), and returns psi (B, l + 1) f32 on the device.
    It runs ``hidden_states``, never the head: no logits.  One session's
    engine takes ``lambda t: encode(t[None])[0]``.

    On a card, a trunk that ``graphable`` admits runs the whole body
    (hidden states, pool, projection, transform) as one CUDA graph for
    each batch size, power-of-two row length and dtype of ``tokens``,
    captured the first time it is seen (``_GraphedEncoder``): a call then
    costs the host one pad, one copy, one replay and one clone instead of
    a launch per op.  Its psi is the eager forward's bit for bit where S
    is a power of two, and to rounding where the pad widens the rows
    (causal attention and the masked pool keep pads out of every real
    row).  A trunk with MoE layers stays eager: each of its layers
    records a ``serve.moe`` span and adds to ``EXPERT_LOAD`` on the host,
    which a replay would not.  So does the CPU, unpadded.
    ``serve.telemetry.ENCODER_GRAPHS`` counts either way.
    """
    dev = resolve_device(device)
    params = _to_device(params, dev)
    proj = torch.as_tensor(proj, device=dev)

    def body(tokens: torch.Tensor) -> torch.Tensor:
        hidden = tf.hidden_states(params, tokens, cfg)
        mask = (tokens >= 0)[..., None]
        pooled = (hidden * mask).sum(1) / torch.clamp(mask.sum(1), min=1)
        # a bf16 backbone's pool meets an f32 proj in f32, as jnp promotes
        dt = torch.promote_types(pooled.dtype, proj.dtype)
        return transform_queries(pooled.to(dt) @ proj.to(dt))

    if dev.type == "cuda" and graphable(cfg):
        return _GraphedEncoder(body, dev, (cfg.q_chunk, cfg.kv_chunk))

    @torch.inference_mode()
    def encode(tokens) -> torch.Tensor:
        ENCODER_GRAPHS.count("eager")
        return body(torch.as_tensor(tokens, device=dev))

    return encode


def graphable(cfg) -> bool:
    """Whether the query encoder replays ``cfg``'s trunk from a CUDA graph
    on a card: a trunk without MoE layers.  The dropless MoE layer's
    ``serve.moe`` spans and ``EXPERT_LOAD`` adds are host work per layer
    and call, which a replay skips."""
    return cfg.moe is None


class _GraphedEncoder:
    """``body(tokens)`` replayed from one CUDA graph per shape and dtype
    of ``tokens`` right-padded with -1 to a power-of-two length
    (``pad_length``), all in one memory pool: a caller that varies S,
    such as one session's engine at B = 1, gets a graph for each power of
    two, not for each S.

    A new shape is captured inside a ``serve.encoder_capture`` span: two
    eager passes on a side stream (cuBLAS makes its workspace for that
    stream there), a device sync (``serve.sync.encoder_capture``), then
    the capture in thread-local mode, so that other threads launching work
    meanwhile neither break it nor land in it.  A call copies the tokens
    into the graph's input, replays on the caller's stream and returns a
    clone of the output, which the next call cannot overwrite.  A graph
    reuses its input and output, and the graphs share their scratch, so
    calls are made on one stream, one after another (as the engines make
    them); a graph keeps the math settings (TF32) in force when it was
    captured.  ``body`` is the eager forward, op by op."""

    WARMUP = 2

    def __init__(self, body: Callable, dev: torch.device, chunks: tuple):
        self.body, self._dev, self._chunks = body, dev, chunks
        self._graphs: dict = {}          # (shape, dtype) -> (graph, in, out)
        self._stream = torch.cuda.Stream(dev)
        self._pool = torch.cuda.graph_pool_handle()

    @torch.inference_mode()
    def __call__(self, tokens) -> torch.Tensor:
        tokens = pad_length(torch.as_tensor(tokens, device=self._dev),
                            self._chunks)
        key = (tokens.shape, tokens.dtype)
        held = self._graphs.get(key)
        if held is None:
            with _CAPTURE:
                held = self._graphs[key] = self._record(tokens)
            ENCODER_GRAPHS.count("captures", tuple(tokens.shape))
        graph, static_in, static_out = held
        static_in.copy_(tokens)
        graph.replay()
        ENCODER_GRAPHS.count("replays")
        return static_out.clone()

    def _record(self, tokens: torch.Tensor) -> tuple:
        static_in = tokens.clone()
        self._stream.wait_stream(torch.cuda.current_stream(self._dev))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self._stream):
            for _ in range(self.WARMUP):
                self.body(static_in)
            with _CAPTURE_SYNC:
                torch.cuda.synchronize(self._dev)
            graph.capture_begin(pool=self._pool,
                                capture_error_mode="thread_local")
            try:
                static_out = self.body(static_in)
            finally:
                graph.capture_end()
        return graph, static_in, static_out


def pad_length(tokens: torch.Tensor, chunks: tuple = ()) -> torch.Tensor:
    """(B, S) token rows right-padded with -1 to the next power-of-two
    length: ``tokens`` itself where S is one, or where that length would
    be neither within nor a multiple of one of ``chunks`` (the attention's
    query and KV chunks, powers of two in every config)."""
    s = tokens.shape[-1]
    width = layout.next_pow2(s)
    if width == s or any(width > c and width % c for c in chunks):
        return tokens
    return torch.nn.functional.pad(tokens, (0, width - s), value=-1)


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return torch.as_tensor(tree, device=dev)


@dataclasses.dataclass
class EngineTurn:
    ids: np.ndarray
    scores: np.ndarray
    hit: bool
    degraded: bool
    latency_s: float
    # serving tier: "l1" (session cache), "l2" (shared shard cache),
    # "l2_reuse" (the shared tier's result memo) or "backend" (full
    # retrieval); ``hit`` is the paper's notion — True iff no back-end
    # query ran
    tier: str = "l1"
    # admission -> wave start, and the wave-level span breakdown
    # (``repro_torch.serve.telemetry.TurnSpans``) for batched turns
    queue_wait_s: float = 0.0
    spans: Optional[object] = None
    # returned docs that cluster prefetch brought into the session cache
    prefetch_hits: int = 0


def radius_from_scores(scores: np.ndarray) -> np.ndarray:
    """Eq. 1 distance of unit vectors from their inner products, in f32."""
    s = np.asarray(scores, np.float32)
    return np.sqrt(np.clip(np.float32(2.0) - np.float32(2.0) * s,
                           np.float32(0.0), None))


def radius_and_docs(scores: np.ndarray, ids: np.ndarray,
                    doc_embeddings: torch.Tensor):
    """r_a and the insertable docs of one merged back-end row.

    r_a comes from the LAST VALID column (short merges are padded with
    (-inf, -1) sentinels), never from a sentinel.  The embeddings are
    gathered on ``doc_embeddings``' device; sentinel ids are clipped for
    the lookup and never inserted.
    """
    n_valid = int((ids >= 0).sum())
    if n_valid == 0:
        raise TimeoutError("back-end answer holds no valid documents")
    radius = float(radius_from_scores(scores[n_valid - 1]))
    idx = torch.as_tensor(np.maximum(ids, 0), device=doc_embeddings.device)
    return radius, doc_embeddings[idx], torch.as_tensor(ids)


class ConversationalEngine:
    """One engine serves one client session at a time (the paper's client
    model); the router and its shards are shared across engines.

    ``doc_embeddings`` (N, width >= dim) are the transformed corpus rows the
    engine inserts, moved to ``device`` once (None means ``cuda``; a tensor
    already there is used without a copy).  ``dtype`` is the cache storage
    format (None follows ``REPRO_CORPUS_DTYPE``).
    """

    def __init__(self, router, doc_embeddings, *, dim: int, k: int = 10,
                 k_c: int = 1000, epsilon: float = 0.04,
                 capacity: Optional[int] = None,
                 encoder: Optional[Callable] = None,
                 dtype: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        self.router = router
        self.doc_embeddings = torch.as_tensor(doc_embeddings,
                                              device=self.device)
        self.k, self.k_c, self.epsilon = k, k_c, epsilon
        self.encoder = encoder
        self.cache = MetricCache(CacheConfig(
            capacity=capacity or 16 * k_c, dim=dim, epsilon=epsilon,
            store_dtype=quant.resolve_dtype(dtype)), self.device)
        self.turns: list[EngineTurn] = []

    def start_session(self):
        self.cache.reset()
        self.turns = []

    def answer(self, query) -> EngineTurn:
        t0 = time.perf_counter()
        psi = self.encoder(query) if self.encoder else query
        psi = torch.as_tensor(psi, device=self.device).to(torch.float32)
        probe = self.cache.probe(psi)
        need_backend = self.cache.n_queries == 0 or not bool(probe.hit)
        degraded = False
        if need_backend:
            try:
                ans, degraded = self.router.search(
                    psi.cpu().numpy()[None], self.k_c)
                radius, emb, ids = radius_and_docs(
                    ans.scores[0], ans.ids[0], self.doc_embeddings)
                # a degraded merge misses shards, so its k_c-th distance is
                # inflated: keep the docs, skip the (psi, r_a) record
                self.cache.insert(psi, radius, emb, ids, record=not degraded)
            except TimeoutError:
                # total back-end failure: answer from the cache if possible
                degraded = True
                if self.cache.n_docs == 0:
                    raise
        scores, _dists, ids, _ = self.cache.query(psi, self.k)
        # a cache holding fewer than k docs pads with (id -1, score -inf)
        # sentinel slots; drop them so they never reach rankings or metrics
        ids, scores = ids.cpu().numpy(), scores.cpu().numpy()
        real = ids >= 0
        turn = EngineTurn(ids=ids[real], scores=scores[real],
                          hit=not need_backend, degraded=degraded,
                          latency_s=time.perf_counter() - t0,
                          tier="l1" if not need_backend else "backend")
        self.turns.append(turn)
        return turn

    def hit_rate(self) -> float:
        if len(self.turns) <= 1:
            return float("nan")
        return float(np.mean([t.hit for t in self.turns[1:]]))
