"""Conversational search through the metric cache with an MLA + MoE query
encoder in bf16 (``moonlight-16b-a3b``).

The system is ``cast19-star``'s (``drivers/conversational.py``, whose
serve loop, front door, wave phases and check helpers this driver reuses
unchanged), with the query encoder ``serve.engine.make_lm_query_encoder``
over the configuration's model: DeepSeek-V3's decoder as the published
``config.json`` gives it (MLA with no query latent, sigmoid-routed experts
with a correction bias, dropless), whole and in bf16.

Inputs, all from the seed: the encoder's weights
(``chipbench.inputs_mla_moe``), the token scripts over the model's
vocabulary, and ``cast19-star``'s corpus planted around the psi that the
reference gives each distinct turn with bf16 products (the configuration's
precision), which keeps set-up near ``cast19-star``'s.

What it measures beyond ``cast19-star``: each call of the expert products
(``models.moe.expert_products``) is wrapped in a ``cb.experts#<n>`` range,
and a routed call's group ends are copied into a device ring, so that its
work is counted after the window with no sync; the program's expert load
counter (``serve.telemetry.EXPERT_LOAD``) is read at the window's two
ends.

The check (after the window, the program's state freed): the psi the
program gave the sampled conversations' rows against the f32 reference
(``psi_gap``: the largest L2 gap of a row, which is what moves a
distance), each turn's hit decision against a plain replay of the cache
over the reference psi (``decision_flips``; a decision whose margin lies
within the ``psi_gap`` limit of epsilon follows the program), and each
answer against the replay's (``answer_gap``, each answered document
scored by the reference, fetched by the replay or not).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from chipbench import costs, costs_mla_moe, inputs, inputs_mla_moe
from chipbench.drivers import conversational as conv
from chipbench.drivers.common import Timed, no_tf32, trace_span
from chipbench.record import Call, RunRecord
from chipbench.reference import cache as ref_cache
from chipbench.reference import full_f32
from chipbench.reference import knn as ref_knn
from chipbench.reference import mla_moe_encoder as ref_encoder
# the program's expert load counter: a program without the dropless MoE
# path has none and fails here, as the harness loads the driver, before a
# kernel is built or a byte allocated
from repro_torch.serve.telemetry import EXPERT_LOAD

RING = 1 << 17           # expert calls whose group ends are kept


def transformer_config(cfg: dict):
    """The program's configuration of the published keys; refuses a
    mechanism the program does not have."""
    from repro_torch.models.moe import MoEConfig
    from repro_torch.models.transformer import MLAConfig, TransformerConfig
    want = {"model_type": "deepseek_v3", "hidden_act": "silu",
            "scoring_func": "sigmoid", "topk_method": "noaux_tc",
            "n_group": 1, "topk_group": 1, "moe_layer_freq": 1,
            "num_nextn_predict_layers": 0, "attention_bias": False}
    off = {k: cfg[k] for k, v in want.items() if cfg[k] != v}
    if off:
        raise ValueError(f"not supported by the program: {off}")
    if cfg["num_key_value_heads"] != cfg["num_attention_heads"]:
        raise ValueError("MLA has one key and value per head")
    qe = cfg["model"]
    return TransformerConfig(
        name=cfg["name"], n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        attention="mla",
        mla=MLAConfig(q_lora_rank=cfg["q_lora_rank"],
                      kv_lora_rank=cfg["kv_lora_rank"],
                      qk_nope_dim=cfg["qk_nope_head_dim"],
                      qk_rope_dim=cfg["qk_rope_head_dim"],
                      v_head_dim=cfg["v_head_dim"]),
        moe=MoEConfig(n_experts=cfg["n_routed_experts"],
                      top_k=cfg["num_experts_per_tok"],
                      d_ff=cfg["moe_intermediate_size"],
                      n_shared=cfg["n_shared_experts"],
                      d_ff_shared=(cfg["moe_intermediate_size"]
                                   * cfg["n_shared_experts"]),
                      capacity_factor=None, norm_topk=cfg["norm_topk_prob"],
                      scoring="sigmoid",
                      routed_scale=cfg["routed_scaling_factor"]),
        n_dense_layers=cfg["first_k_dense_replace"], mtp=False,
        tie_embeddings=cfg["tie_word_embeddings"],
        rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["rms_norm_eps"],
        dtype=inputs_mla_moe.DTYPES[qe["dtype"]],
        q_chunk=qe["q_chunk"], kv_chunk=qe["kv_chunk"])


class Experts:
    """Stands in for ``models.moe.expert_products`` while the cell runs:
    each call inside a ``cb.experts#<n>`` range, its host interval kept in
    numpy arrays, a routed call's group ends copied (after its range) into
    a device ring.  Nothing a call keeps is a Python object, so the cyclic
    collector never sees them."""

    def __init__(self, fn, tracer, n_experts: int, device):
        self.fn, self.tracer = fn, tracer
        self.ends = torch.zeros((RING, n_experts), dtype=torch.int32,
                                device=device)
        self.t0 = np.zeros(RING)
        self.t1 = np.zeros(RING)
        self.routed = np.zeros(RING, bool)
        self.n = 0

    def __call__(self, x, wi, wo, ends=None):
        i = self.n
        self.n += 1
        j = i % RING
        self.t0[j] = time.perf_counter()
        with self.tracer.range(f"cb.experts#{i}"):
            out = self.fn(x, wi, wo, ends)
        self.t1[j] = time.perf_counter()
        self.routed[j] = ends is not None
        if ends is not None:
            self.ends[j].copy_(ends)
        return out

    def calls(self, cfg: dict, lo: float, hi: float) -> list:
        """The calls that began in [lo, hi] and the ring still holds, each
        with its work: a routed call's from its group ends, a shared
        call's from the real tokens of the routed call before it."""
        first = max(self.n - RING + 1, 0)
        idx = [i for i in range(first, self.n)
               if lo <= self.t0[i % RING] <= hi]
        ends = self.ends.cpu().numpy()
        k = cfg["num_experts_per_tok"]
        out = []
        for i in idx:
            j = i % RING
            if self.routed[j]:
                work = costs_mla_moe.routed_work(cfg, ends[j])
            elif i > first and self.routed[(i - 1) % RING]:
                real = int(ends[(i - 1) % RING][-1]) // k
                work = costs_mla_moe.shared_work(cfg, real)
            else:
                continue
            out.append(Call(f"cb.experts#{i}", self.t0[j], self.t1[j],
                            *work))
        return out


class LoadWindow:
    """Around the encoder: a snapshot of the program's expert load counter
    at the first call at or after each end of the window (a device copy,
    no sync)."""

    def __init__(self, fn):
        self.fn = fn
        self.bounds: list = []
        self.snaps: list = []

    def arm(self, t_open: float, t_close: float) -> None:
        self.bounds, self.snaps = [t_open, t_close], []

    def __call__(self, tokens):
        if self.bounds and time.perf_counter() >= self.bounds[0]:
            self.bounds.pop(0)
            self.snaps.append(EXPERT_LOAD.snapshot())
        return self.fn(tokens)

    def routed(self):
        """(layers, E) routed real tokens between the two snapshots (the
        counter's end state when no call came after the close), or None."""
        if not self.snaps or self.snaps[0] is None:
            return None
        end = self.snaps[1] if len(self.snaps) > 1 else None
        return EXPERT_LOAD.read(self.snaps[0], end)["routed"]


class System(conv.System):
    def __init__(self, ctx, scripts, recipe):
        super().__init__(ctx, scripts, recipe)
        self.experts = None        # Experts around the expert products
        self.load = None           # LoadWindow around the encoder
        self.expert_fn = None      # the program's own expert products


def make_inputs(ctx):
    """The encoder's weights, the pool of token scripts, and the corpus
    recipe that plants documents around the reference psi (bf16 products)
    of every distinct turn of the pool."""
    cfg = ctx.cfg
    weights = inputs_mla_moe.encoder_weights(cfg, ctx.seed, ctx.device)
    scripts = inputs.token_scripts(cfg["scripts"], cfg["vocab_size"],
                                   ctx.seed)
    tok = torch.as_tensor(scripts.unique_rows, device=ctx.device)
    with torch.no_grad():
        centres = ref_encoder.encode_rows(weights, tok, cfg, "bf16",
                                          rows=512)[:, :-1].contiguous()
    n_scripts = scripts.unique.shape[0]
    centre_script = np.zeros(scripts.unique_rows.shape[0], np.int64)
    for c in range(n_scripts):
        centre_script[scripts.unique[c]] = c
    recipe = inputs.corpus_recipe(cfg, centres, centre_script, n_scripts,
                                  ctx.seed)
    return weights, scripts, recipe


def setup(ctx) -> System:
    # the program's configuration first: it refuses a configuration whose
    # mechanisms the program lacks before any large allocation
    tcfg = transformer_config(ctx.cfg)
    from repro_torch.core.embedding import transform_documents
    from repro_torch.dist.retrieval import DeviceShard
    from repro_torch.models import moe
    from repro_torch.serve import ShardedRouter
    from repro_torch.serve.engine import make_lm_query_encoder
    from repro_torch.serve.session import BatchedEngine, SessionManager

    no_tf32()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg, dev, log = ctx.cfg, ctx.device, ctx.log
    cc, cache = cfg["corpus"], cfg["cache"]
    if ctx.traffic["entry"] != "sessions":
        raise ValueError(f"entry {ctx.traffic['entry']!r}: expected sessions")
    t0 = time.perf_counter()
    weights, scripts, recipe = make_inputs(ctx)
    t1 = time.perf_counter()
    dim = cfg["model"]["out_dim"] + 1
    width = cc["stored_width"]
    corpus = torch.zeros((cc["n_docs"], width), dtype=torch.float32,
                         device=dev)
    norms = recipe.norms()
    m = float(norms.max())
    with torch.no_grad():
        for lo, hi, raw in recipe.blocks(norms):
            corpus[lo:hi, :dim] = transform_documents(raw, m)[0]
    del norms
    if dev != "cpu":
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    sysm = System(ctx, scripts, recipe)
    sysm.corpus = corpus
    ids = torch.arange(cc["n_docs"], dtype=torch.int32, device=dev)
    shard = DeviceShard(corpus, ids, device=dev, dtype="fp32")

    def knn_work(args, out):
        return costs.knn_search(len(args[0]), cc["n_docs"], dim, width,
                                int(args[1]))

    sysm.knn = Timed(shard, "cb.knn", ctx.tracer, knn_work)
    sysm.router = ShardedRouter([sysm.knn], deadline_s=conv.GRACE_S,
                                hedge_after_s=conv.GRACE_S, max_retries=0,
                                n_docs=cc["n_docs"])
    sysm.expert_fn = moe.expert_products
    sysm.experts = Experts(sysm.expert_fn, ctx.tracer,
                           cfg["n_routed_experts"], dev)
    moe.expert_products = sysm.experts
    encode = make_lm_query_encoder(weights["params"], tcfg, weights["proj"],
                                   device=dev)
    del weights
    sysm.load = LoadWindow(encode)
    sysm.encoder = Timed(sysm.load, "cb.encoder", ctx.tracer, keep=True)
    sysm.telemetry = conv._wave_log_class()()
    sysm.engine = BatchedEngine(
        sysm.router, corpus, n_sessions=cfg["engine"]["n_sessions"],
        encoder=sysm.encoder, telemetry=sysm.telemetry, dim=dim,
        k=cache["k"], k_c=cache["k_c"], epsilon=cache["epsilon"],
        capacity=cache["capacity"], dtype="fp32", device=dev)
    conv._wrap_phases(sysm.engine, ctx.tracer)
    conv.warm_waves(sysm, conv._largest_wave(ctx))
    sysm.mgr = SessionManager(sysm.engine,
                              max_slots=cfg["engine"]["max_wave"])
    if dev != "cpu":
        torch.cuda.synchronize()
    sysm.encoder.reset()
    sysm.knn.reset()
    log(f"[setup] weights and {scripts.unique_rows.shape[0]} planted centres "
        f"in {t1 - t0:.2f} s; corpus {tuple(corpus.shape)} f32 "
        f"({corpus.numel() * 4 / 1e9:.2f} GB, M={m:.6f}) in {t2 - t1:.2f} s; "
        f"engine built and warmed in {time.perf_counter() - t2:.2f} s")
    return sysm


fresh_front_door = conv.fresh_front_door        # for sweep.py


# ------------------------------------------------------------------- serve
def serve(sysm, ctx) -> RunRecord:
    """``cast19-star``'s serve loop, with this family's accounting of the
    encoder's work swapped in for the dense encoder's while it runs."""
    ramp = float(ctx.traffic["ramp_s"])
    now = time.perf_counter()
    sysm.load.arm(now + ramp, now + ramp + ctx.seconds)
    saved = conv._window_flops, conv._encoder_calls
    conv._window_flops, conv._encoder_calls = _window_flops, _encoder_calls
    try:
        rec = conv._serve_sessions(sysm, ctx)
    finally:
        conv._window_flops, conv._encoder_calls = saved
    rec.expert_load = sysm.load.routed()
    if rec.trace is not None:
        lo, hi = trace_span(ctx, rec.t_open)
        rec.calls["experts"] = sysm.experts.calls(ctx.cfg, lo - 1.0,
                                                  hi + 1.0)
    return rec


def _encoder_calls(sysm) -> list:
    """The encoder's calls, each with the operations of the rows it was
    handed (their real tokens)."""
    out = []
    for call, (args, _psi) in zip(sysm.encoder.calls, sysm.encoder.kept):
        tok = np.asarray(torch.as_tensor(args[0]).cpu())
        call.flops = costs_mla_moe.encoder_flops(sysm.ctx.cfg,
                                                 (tok >= 0).sum(-1).ravel())
        out.append(call)
    return out


def _window_flops(sysm, rec: RunRecord) -> float:
    """Model flops of the turns answered in the window: the encoder over
    each turn's real tokens, and a corpus scan for each miss."""
    cfg = sysm.ctx.cfg
    cc = cfg["corpus"]
    scan = costs.knn_search(1, cc["n_docs"],
                            cfg["model"]["out_dim"] + 1,
                            cc["stored_width"], cfg["cache"]["k_c"])[0]
    total = 0.0
    for r in rec.requests:
        if r.ok and rec.in_window(r.done):
            n = int(sysm.scripts.lengths[conv._script(sysm, r), r.turn])
            total += costs_mla_moe.encoder_flops(cfg, [n])
            if not r.hit:
                total += scan
    return total


# -------------------------------------------------------------- release
def release(sysm) -> None:
    """Free the program's state (the encoder's weights with it: the calls'
    psi stay for the check) and give the program back its own expert
    products."""
    from repro_torch.models import moe
    if sysm.expert_fn is not None:
        moe.expert_products = sysm.expert_fn
    sysm.experts = sysm.load = sysm.encoder.fn = None
    conv.release(sysm)


# ---------------------------------------------------------------- check
def compare(ctx, scripts, recipe, convs: list, psi: dict) -> dict:
    """{number: value}: the answers ``convs`` and the ``psi`` of their
    rows held against the reference in float32."""
    cfg, dev = ctx.cfg, ctx.device
    band = float(cfg["limits"]["psi_gap"])
    if not convs:
        raise RuntimeError("no conversation of the window to check")
    need = sorted(psi)
    pos = {u: i for i, u in enumerate(need)}
    tok = torch.as_tensor(scripts.unique_rows[need], device=dev)
    with full_f32(), torch.no_grad():
        weights = inputs_mla_moe.encoder_weights(cfg, ctx.seed, dev)
        psi_ref = ref_encoder.encode_rows(weights, tok, cfg)
        del weights
        gaps = torch.cat([torch.linalg.vector_norm(
            psi[u].to(dev).float().reshape(-1, psi_ref.shape[1])
            - psi_ref[pos[u]], dim=-1) for u in need])
        psi_gap = float(gaps.max())
        top_s, top_i = ref_knn.corpus_topk(recipe, psi_ref,
                                           cfg["cache"]["k_c"])
        answered = np.concatenate([ids for turns in convs
                                   for _, _, ids in turns]).astype(np.int64)
        union = torch.unique(torch.cat([top_i.reshape(-1), torch.as_tensor(
            answered, device=top_i.device)]))
        docs = ref_knn.corpus_rows(recipe, union)
        row_of = {int(d): j for j, d in enumerate(union.tolist())}
        flips = border = 0
        gap = 0.0
        for turns in convs:
            idx = [pos[u] for u, _, _ in turns]
            prog_ids = [ids for _, _, ids in turns]
            checks = ref_cache.replay(
                psi_ref[idx], np.array([h for _, h, _ in turns]), prog_ids,
                top_s[idx], top_i[idx], docs, row_of,
                conv.cache_config(cfg), band)
            flips += sum(c.flip for c in checks)
            border += sum(c.borderline for c in checks)
            gap = max(gap, answer_gap(psi_ref[idx], checks, prog_ids,
                                      top_i[idx], docs, row_of,
                                      cfg["cache"]["k"]))
    q = torch.quantile(gaps, torch.tensor([0.5, 0.99], device=dev)).tolist()
    ctx.log(f"[check] {len(convs)} conversations, "
            f"{sum(map(len, convs))} turns, {len(need)} distinct rows "
            f"({gaps.numel()} psi: L2 gap p50 {q[0]:.4g}, p99 {q[1]:.4g}); "
            f"{border} decisions within {band} of epsilon followed the "
            f"program")
    return {"psi_gap": psi_gap, "decision_flips": float(flips),
            "answer_gap": gap}


def answer_gap(psi: torch.Tensor, checks: list, prog_ids: list,
               topk_ids: torch.Tensor, docs: torch.Tensor, row_of: dict,
               k: int) -> float:
    """The widest gap, over one conversation's turns, by which a document
    of the program's answer scores below the replay's document of the same
    rank (``ref_cache.answer_gap``), every document scored by the
    reference: the replay's cache follows its decisions (``checks``), and
    a document of the program's answer that the replay's cache lacks is
    scored from its own row of ``docs`` instead of reading +inf.  With a
    bf16 encoder the program's k_c documents of a miss and the
    reference's differ near the k_c-th, so a later answer can hold a
    document the replay never fetched; how much worse it scores is the
    error.  A short or repeated answer still reads +inf."""
    cached: list = []
    seen: set = set()
    gap = 0.0
    for t, c in enumerate(checks):
        if not c.hit:
            for i in topk_ids[t].tolist():
                if i not in seen:
                    seen.add(i)
                    cached.append(i)
        own = [int(i) for i in prog_ids[t]]
        rows = torch.as_tensor([row_of[i] for i in cached + own],
                               device=docs.device)
        s = (docs[rows] @ psi[t]).tolist()
        top = sorted(s[:len(cached)], reverse=True)[:k]
        score_of = dict(zip(cached + own, s))
        gap = max(gap, ref_cache.answer_gap(np.asarray(top), score_of,
                                            np.asarray(own), k))
    return gap


def check(sysm, rec: RunRecord, ctx) -> dict:
    convs, psi = conv.program_outputs(sysm, rec)
    return compare(ctx, sysm.scripts, sysm.recipe, convs, psi)


def control(ctx) -> dict:
    """The check's numbers with the reference at fp8 (e4m3 operands, one
    step below the configuration's bf16) as the encoder in the program's
    place: as many conversations as a run compares, drawn from the seed
    among the pool's scripts, each served by a plain replay of its cache
    over the fp8 encoder's psi and the exact f32 scan."""
    weights, scripts, recipe = make_inputs(ctx)
    cfg, dev = ctx.cfg, ctx.device
    n_turns = int(ctx.traffic["turns"])
    pick = conv.sample(range(scripts.unique.shape[0]),
                       int(ctx.traffic["sample"]), ctx.seed, "check")
    need = sorted({int(scripts.unique[c, t]) for c in pick
                   for t in range(n_turns)})
    pos = {u: i for i, u in enumerate(need)}
    tok = torch.as_tensor(scripts.unique_rows[need], device=dev)
    with full_f32(), torch.no_grad():
        psi = ref_encoder.encode_rows(weights, tok, cfg, "fp8")
        del weights
        top_s, top_i = ref_knn.corpus_topk(recipe, psi, cfg["cache"]["k_c"])
        union = torch.unique(top_i)
        docs = ref_knn.corpus_rows(recipe, union)
        row_of = {int(d): j for j, d in enumerate(union.tolist())}
        convs = []
        for c in pick:
            idx = [pos[int(scripts.unique[c, t])] for t in range(n_turns)]
            served = ref_cache.serve(psi[idx], top_s[idx], top_i[idx], docs,
                                     row_of, conv.cache_config(cfg))
            convs.append([(int(scripts.unique[c, t]), hit, ids)
                          for t, (hit, ids) in enumerate(served)])
        del docs
    return compare(ctx, scripts, recipe, convs,
                   {u: psi[pos[u]] for u in need})
