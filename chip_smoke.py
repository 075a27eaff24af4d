#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Run from the repository root.  Phases, each fatal on failure:

  1. device  — needs a CUDA card; prints its name and power limit as
     ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
     gives them.
  2. build   — ``nvcc`` builds every kernel source of ``src/repro_torch/csrc``
     (one process per source, all started together).
  3. kernels — every kernel against its plain PyTorch version on the card,
     on the same inputs, at the serving path's shapes: the probe (S=64,
     Qmax=64, dim 769), the wave in its three modes and three store dtypes
     (S=64, capacity 16000, k_c=1000, k=10), and the kNN search (B=64,
     k=1000; fp32 at N=8,841,823, bf16 / int8 / int8-dot at N=1,000,000).
     Each is timed with CUDA events beside its plain version, its bound and,
     where one PyTorch call computes the same function, that call.
  4. main    — the serving path: ``make_world`` (60,000 docs, 64
     conversations of 10 turns, dim 768) plus background distractors drawn
     on the card from a seeded generator fill the corpus to N = 8,841,823
     (the MS MARCO passage collection of TREC CAsT 2019); one Eq. 1 M over
     the whole corpus.  ``SessionManager`` -> ``BatchedEngine(64 sessions,
     k=10, k_c=1000, epsilon=0.04, capacity=16000)`` ->
     ``ShardedRouter([DeviceShard(fp32)])`` serves the 10 turns of every
     conversation, then one round that re-asks each last turn.  The kernel
     counters, zeroed just before, must show 3 launches per wave with a
     miss (the kNN search counted as one) and 2 per wave without; every
     miss turn must match an exact plain search over the whole corpus, and
     the same engine on a small input must answer as the CPU path does.

Tolerances (the kernels and the plain versions sum f32 dot products in
different orders): scores and r_hat within 1e-5 and 1e-4 (r_hat takes a
square root of 2 - 2s, which widens the score's error); ranks compared by
``repro_torch.kernels.parity.assert_topk_agree`` (ids equal where the score
gap to the neighbouring ranks exceeds the tolerance, as sets inside tied
runs).  Wave states must be equal bit for bit: the scatter copies rows.

Output: progress lines, then the ``{"kernels": [...]}`` line, the
nvidia-smi line, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_CORPUS = 8_841_823          # MS MARCO passages (TREC CAsT 2019 collection)
N_SMALL = 1_000_000           # corpus of the bf16 / int8 kNN checks
S, QMAX, DIM_RAW = 64, 64, 768
CAPACITY, KC, K, EPS = 16000, 1000, 10, 0.04
SCORE_TOL, RHAT_TOL = 1e-5, 1e-4
DEV = "cuda"
# H100 SXM data sheet, dense: HBM bytes/s; f32 (CUDA cores) and int8
# (tensor cores) operations/s
HBM_BPS, F32_OPS, I8_OPS = 3.35e12, 67e12, 1979e12

SRC = "src/repro_torch/csrc/"
TPU = "src/repro/kernels/"
KERNELS = {
    "cache_probe": ("cache_probe.cu", "cache_probe/cache_probe.py:81"),
    "knn_score": ("knn.cu", "knn/knn.py:197"),
    "knn_select": ("knn.cu", "knn/knn.py:197"),
    "wave_insert_query": ("cache_wave.cu", "cache_wave/ops.py:255"),
    "wave_query_topk": ("cache_wave.cu", "cache_wave/ops.py:163"),
    "wave_insert_scatter": ("cache_wave.cu", "cache_wave/ops.py:234"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, ops: float, rate: float):
    """(least time in ms, what bounds it) for moving ``nbytes`` through
    device memory and doing ``ops`` at ``rate``."""
    tb, to = nbytes / HBM_BPS * 1e3, ops / rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def timed(torch, fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` back-to-back calls (after a warm-up),
    from CUDA events."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


class Report:
    def __init__(self):
        self.rows = {}

    def add(self, name, *, err, ms, plain_ms, nbytes, ops, rate,
            library_ms=None):
        bms, by = bound(nbytes, ops, rate)
        self.rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": bms, "bound_by": by,
                           "library_ms": library_ms}
        log(f"[kernels] {name}: max_abs_err={err:.3g} ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={bms:.4f} ({by}) "
            f"library_ms={library_ms}")

    def line(self, counters):
        out = []
        for name, (src, tpu) in KERNELS.items():
            row = self.rows[name]
            out.append({"name": name, "route": "cuda", "source": SRC + src,
                        "replaces": TPU + tpu,
                        "launches": counters[name].launches, **row})
        return json.dumps({"kernels": out})


# ------------------------------------------------------------------ probe
def probe_phase(torch, rep: Report, gen):
    from repro_torch.core import cache_ops as tc
    from repro_torch.kernels.cache_probe import ops as probe_ops
    from repro_torch.kernels.cache_probe import ref as probe_ref
    from repro_torch.kernels.parity import assert_close

    cfg = tc.CacheConfig(capacity=CAPACITY, dim=DIM_RAW + 1,
                         max_queries=QMAX)
    dp, qp = cfg.phys_dim, cfg.phys_max_queries
    psi = torch.nn.functional.normalize(
        torch.randn(S, dp, generator=gen, device=DEV), dim=1)
    psi[:, cfg.dim:] = 0
    psi = torch.nn.functional.normalize(psi, dim=1)
    noise = torch.randn(S, qp, dp, generator=gen, device=DEV)
    noise[..., cfg.dim:] = 0
    spread = torch.linspace(0.3, 1.5, qp, device=DEV)[None, :, None]
    recs = torch.nn.functional.normalize(
        psi[:, None, :] + spread * noise / cfg.dim ** 0.5, dim=2)
    radius = 0.3 + 0.8 * torch.rand(S, qp, generator=gen, device=DEV)
    n_queries = torch.randint(0, 2 * QMAX, (S,), generator=gen,
                              device=DEV, dtype=torch.int32)
    n_queries[:4] = torch.tensor([0, 1, QMAX, QMAX + 9], dtype=torch.int32)
    for dtype in ("fp32", "bf16", "int8"):
        q_emb, q_scale = tc.store_rows(recs, dtype)
        hit, r_best, near = probe_ops.cache_probe_batched(
            q_emb, psi[:, :cfg.dim], radius, n_queries, 0.25, q_scale=q_scale,
            max_queries=QMAX)
        cpu = [t.cpu() for t in (q_emb, psi[:, :cfg.dim], radius, n_queries)]
        phit, pbest, pnear = probe_ops.cache_probe_batched(
            *cpu, 0.25, q_scale=q_scale.cpu(), max_queries=QMAX)
        if not (torch.equal(hit.cpu(), phit) and torch.equal(near.cpu(), pnear)):
            raise AssertionError(f"probe {dtype}: hit / nearest_q differ")
        if not (phit.any() and not phit.all()):
            raise AssertionError("probe inputs must mix hits and misses")
        rk = probe_ops.probe_rhat_batched(q_emb, psi, radius, q_scale)
        rp = probe_ref.probe_rhat_batched(q_emb, psi, radius, q_scale)
        err = assert_close(rk, rp, RHAT_TOL, f"probe {dtype} r_hat")
        assert_close(r_best.cpu(), pbest, RHAT_TOL, f"probe {dtype} best")
        log(f"[kernels] cache_probe {dtype}: ok (max_abs_err {err:.3g})")
        if dtype == "fp32":
            fp32 = (q_emb, q_scale, err)
    q_emb, q_scale, err = fp32
    ms = timed(torch, lambda: probe_ops.probe_rhat_batched(
        q_emb, psi, radius, q_scale), 50)
    plain = timed(torch, lambda: probe_ref.probe_rhat_batched(
        q_emb, psi, radius, q_scale), 20)
    rep.add("cache_probe", err=err, ms=ms, plain_ms=plain,
            nbytes=S * qp * dp * 4 + S * dp * 4 + 3 * S * qp * 4,
            ops=2 * S * qp * dp, rate=F32_OPS)


# ------------------------------------------------------------------- wave
def wave_inputs(torch, tc, cfg, gen):
    """A half-full stacked cache and one insert wave at serving shapes."""
    cp, dp = cfg.phys_capacity, cfg.phys_dim
    st = tc.init_batched_cache(cfg, S, DEV)
    n_docs = torch.randint(CAPACITY // 8, CAPACITY * 3 // 4, (S,),
                           generator=gen, device=DEV)
    rows = torch.nn.functional.normalize(torch.randn(
        S, cp, cfg.dim, generator=gen, device=DEV), dim=2)
    data, scale = tc.store_rows(rows, cfg.store_dtype)
    del rows
    live = torch.arange(cp, device=DEV)[None, :] < n_docs[:, None]
    st.doc_emb[..., :cfg.dim] = data * live[..., None].to(data.dtype)
    del data
    st.doc_scale.copy_(torch.where(live, scale, torch.ones_like(scale)))
    ids = torch.arange(S * cp, device=DEV, dtype=torch.int32).view(S, cp)
    st.doc_ids.copy_(torch.where(live, ids, torch.full_like(ids, -1)))
    st.doc_stamp.copy_(live.to(torch.int32))
    st.n_docs.copy_(n_docs.to(torch.int32))
    st.n_queries.copy_(torch.randint(0, 100, (S,), generator=gen,
                                     device=DEV, dtype=torch.int32))
    st.step.fill_(5)
    new = torch.nn.functional.normalize(torch.randn(
        S, KC, cfg.dim, generator=gen, device=DEV), dim=2)
    emb_q, emb_scale = tc.store_rows(new, cfg.store_dtype)
    keep = torch.rand(S, KC, generator=gen, device=DEV) < 0.7
    pos = n_docs[:, None] + torch.cumsum(keep.long(), 1) - 1
    pos = torch.where(keep & (pos < CAPACITY), pos,
                      torch.full_like(pos, cp)).to(torch.int32)
    new_ids = (10 ** 7 + torch.arange(S * KC, device=DEV)).view(S, KC) \
        .to(torch.int32)
    psi = torch.nn.functional.normalize(torch.randn(
        S, cfg.dim, generator=gen, device=DEV), dim=1)
    psi_q, psi_scale = tc.store_rows(psi, cfg.store_dtype)
    ins = (tc.pad_features(emb_q, dp), emb_scale, new_ids, pos,
           tc.pad_features(psi_q, dp), psi_scale,
           torch.rand(S, generator=gen, device=DEV),
           torch.rand(S, generator=gen, device=DEV) < 0.8,
           torch.remainder(st.n_queries, QMAX), st.step.clone())
    return st, ins, tc.pad_features(psi, dp), int((pos < cp).sum())


def wave_phase(torch, rep: Report, gen):
    from repro_torch.core import cache_ops as tc
    from repro_torch.kernels.cache_wave import ops as wave_ops
    from repro_torch.kernels.cache_wave import ref as wave_ref
    from repro_torch.kernels.parity import assert_topk_agree

    def clone(st):
        return tc.CacheState(*(x.clone() for x in st))

    def leaves(st):
        return (st.doc_emb, st.doc_ids, st.doc_stamp, st.doc_scale,
                st.q_emb, st.q_radius, st.q_scale)

    def same(a, b, what):
        for f, x, y in zip(tc.CacheState._fields, a, b):
            if not torch.equal(x, y):
                raise AssertionError(f"{what}: state leaf {f} differs")

    for dtype in ("fp32", "bf16", "int8"):
        cfg = tc.CacheConfig(capacity=CAPACITY, dim=DIM_RAW + 1,
                             max_queries=QMAX, store_dtype=dtype)
        st, ins, psi, n_kept = wave_inputs(torch, tc, cfg, gen)
        errs = {}
        # insert + query
        sk, sp = clone(st), clone(st)
        vk, ik, slk = wave_ops.wave_insert_query(*leaves(sk), *ins, psi, K)
        wave_ref.insert_scatter(*leaves(sp), *ins)
        vp, ip, _ = wave_ref.query_topk(sp.doc_emb, sp.doc_ids, sp.doc_scale,
                                        psi, K)
        same(sk, sp, f"wave_insert_query {dtype}")
        errs["wave_insert_query"] = assert_topk_agree(
            vk, ik, vp, ip, SCORE_TOL, f"wave_insert_query {dtype}")
        if not torch.equal(torch.gather(sk.doc_ids, 1, slk.long()), ik):
            raise AssertionError("wave slots do not point at the ids")
        # query only, on the post-insert state
        vk, ik, _ = wave_ops.wave_query_topk(sk.doc_emb, sk.doc_ids,
                                             sk.doc_scale, psi, K)
        errs["wave_query_topk"] = assert_topk_agree(
            vk, ik, vp, ip, SCORE_TOL, f"wave_query_topk {dtype}")
        del sk, sp
        # insert only
        sk, sp = clone(st), clone(st)
        wave_ops.wave_insert_scatter(*leaves(sk), *ins)
        wave_ref.insert_scatter(*leaves(sp), *ins)
        same(sk, sp, f"wave_insert_scatter {dtype}")
        errs["wave_insert_scatter"] = 0.0
        del sp
        log(f"[kernels] cache_wave {dtype}: ok "
            f"({n_kept} rows written, max_abs_err {errs})")
        if dtype == "fp32":
            isz, dp, cp = 4, cfg.phys_dim, cfg.phys_capacity
            scan = S * cp * (dp * isz + 8)
            write = n_kept * (2 * dp * isz + 12) + S * KC * 4 + S * 24
            out = S * K * 12 + S * dp * 4
            ops = 2 * S * cp * dp
            lv = leaves(sk)
            rep.add("wave_insert_query", err=errs["wave_insert_query"],
                    ms=timed(torch, lambda: wave_ops.wave_insert_query(
                        *lv, *ins, psi, K), 10),
                    plain_ms=timed(torch, lambda: (
                        wave_ref.insert_scatter(*lv, *ins),
                        wave_ref.query_topk(lv[0], lv[1], lv[3], psi, K)), 3),
                    nbytes=scan + write + out, ops=ops, rate=F32_OPS)
            rep.add("wave_query_topk", err=errs["wave_query_topk"],
                    ms=timed(torch, lambda: wave_ops.wave_query_topk(
                        lv[0], lv[1], lv[3], psi, K), 10),
                    plain_ms=timed(torch, lambda: wave_ref.query_topk(
                        lv[0], lv[1], lv[3], psi, K), 3),
                    nbytes=scan + out, ops=ops, rate=F32_OPS)
            rep.add("wave_insert_scatter", err=0.0,
                    ms=timed(torch, lambda: wave_ops.wave_insert_scatter(
                        *lv, *ins), 10),
                    plain_ms=timed(torch, lambda: wave_ref.insert_scatter(
                        *lv, *ins), 3),
                    nbytes=write, ops=0, rate=F32_OPS)
        del st, sk, ins
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- corpus
def build_corpus(torch, seed: int):
    """World docs + on-card distractors, Eq. 1-transformed with one M,
    stored at the port's padded width (N, 800) f32."""
    from repro_torch.core import embedding as temb
    from repro_torch.core import layout
    from repro_torch.data.conversations import WorldConfig, make_world

    t0 = time.perf_counter()
    world = make_world(WorldConfig(n_conversations=S, seed=seed))
    n_world = world.n_docs
    n_bg = N_CORPUS - n_world
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed + 1)
    jitter = world.cfg.norm_jitter
    bg_norms = 1.0 + jitter * (torch.rand(n_bg, generator=gen,
                                          device=DEV) * 2 - 1)
    world_emb = torch.as_tensor(world.doc_emb, dtype=torch.float32,
                                device=DEV)
    m = max(float(torch.linalg.vector_norm(world_emb, dim=1).max()),
            float(bg_norms.max()))
    dim = DIM_RAW + 1
    corpus = torch.zeros((N_CORPUS, layout.phys_dim(dim)), dtype=torch.float32,
                         device=DEV)
    corpus[:n_world, :dim] = temb.transform_documents(world_emb, m)[0]
    del world_emb
    chunk = 1 << 20
    for lo in range(0, n_bg, chunk):
        hi = min(lo + chunk, n_bg)
        z = torch.nn.functional.normalize(torch.randn(
            hi - lo, DIM_RAW, generator=gen, device=DEV), dim=1)
        corpus[n_world + lo:n_world + hi, :dim] = temb.transform_documents(
            z * bg_norms[lo:hi, None], m)[0]
    del bg_norms
    streams = [temb.transform_queries(torch.as_tensor(
        c.queries, dtype=torch.float32)).numpy() for c in world.conversations]
    torch.cuda.synchronize()
    log(f"[main] corpus {tuple(corpus.shape)} f32 "
        f"({corpus.numel() * 4 / 1e9:.2f} GB), M={m:.6f}, world "
        f"{n_world} docs, built in {time.perf_counter() - t0:.1f} s")
    return world, corpus, streams


# -------------------------------------------------------------------- knn
def knn_phase(torch, rep: Report, corpus, streams):
    import numpy as np

    from repro_torch.core import quant
    from repro_torch.kernels.knn import ops as knn_ops
    from repro_torch.kernels.knn import ref as knn_ref
    from repro_torch.kernels.parity import assert_close, assert_topk_agree

    dp = corpus.shape[1]
    q = torch.nn.functional.pad(torch.as_tensor(
        np.stack([s[0] for s in streams]), device=DEV), (0, dp - DIM_RAW - 1))
    ids = torch.arange(N_CORPUS, dtype=torch.int32, device=DEV)
    # fp32 at full N: kernel against plain, then timing
    vk, ik = knn_ops.knn_search(corpus, ids, q, KC)
    vp, ip = knn_ref.search(corpus, ids, q, KC)
    err = assert_topk_agree(vk, ik, vp, ip, SCORE_TOL, "knn fp32")
    del vp, ip
    sk = knn_ops.knn_score(corpus, ids, q)
    sp = knn_ref.score(corpus, ids, q)
    err_s = assert_close(sk, sp, SCORE_TOL, "knn_score fp32")
    del sp
    sel_v, sel_i = knn_ops.knn_select(sk, ids, KC)
    ref_v, ref_i = knn_ref.select(sk, ids, KC)
    err_sel = assert_topk_agree(sel_v, sel_i, ref_v, ref_i, 0.0,
                                "knn_select fp32")
    del ref_v, ref_i
    log(f"[kernels] knn fp32 N={N_CORPUS}: ok (max_abs_err {err:.3g})")
    b = q.shape[0]
    score_ms = timed(torch, lambda: knn_ops.knn_score(corpus, ids, q), 3)
    score_plain = timed(torch, lambda: knn_ref.score(corpus, ids, q), 2)
    score_lib = timed(torch, lambda: torch.mm(q, corpus.T), 2)
    rep.add("knn_score", err=err_s, ms=score_ms, plain_ms=score_plain,
            nbytes=N_CORPUS * (dp * 4 + 4) + b * dp * 4 + b * N_CORPUS * 4,
            ops=2 * b * N_CORPUS * dp, rate=F32_OPS, library_ms=score_lib)
    sel_ms = timed(torch, lambda: knn_ops.knn_select(sk, ids, KC), 3)
    sel_plain = timed(torch, lambda: knn_ref.select(sk, ids, KC), 2)
    sel_lib = timed(torch, lambda: torch.topk(sk, KC, dim=1), 2)
    rep.add("knn_select", err=err_sel, ms=sel_ms, plain_ms=sel_plain,
            nbytes=b * N_CORPUS * 4 + b * KC * 8, ops=0, rate=F32_OPS,
            library_ms=sel_lib)
    del sk
    torch.cuda.empty_cache()
    op_ms = timed(torch, lambda: knn_ops.knn_search(corpus, ids, q, KC), 3)
    op_plain = timed(torch, lambda: knn_ref.search(corpus, ids, q, KC), 1)
    op_lib = timed(torch, lambda: torch.topk(q @ corpus.T, KC, dim=1), 2)
    op_bound = bound(N_CORPUS * (dp * 4 + 8) + b * dp * 4 + b * KC * 8,
                     2 * b * N_CORPUS * dp, F32_OPS)
    log(f"[kernels] knn_search fp32 (one op, two launches): ms={op_ms:.4f} "
        f"plain_ms={op_plain:.4f} library_ms={op_lib:.4f} "
        f"bound_ms={op_bound[0]:.4f} ({op_bound[1]})")
    torch.cuda.empty_cache()
    # quantized corpora at N_SMALL
    sub = corpus[:N_SMALL]
    for dtype, i8 in (("bf16", False), ("int8", False), ("int8", True)):
        qc = quant.quantize(sub, dtype)
        vk, ik = knn_ops.knn_search(qc.data, ids[:N_SMALL], q, KC,
                                    scale=qc.scale, int8_dot=i8)
        qq, qs = q, None
        if i8:
            qqc = quant.quantize(q, "int8")
            qq, qs = qqc.data, qqc.scale
        vp, ip = knn_ref.search(qc.data, ids[:N_SMALL], qq, KC, qc.scale, qs)
        e = assert_topk_agree(vk, ik, vp, ip, SCORE_TOL, f"knn {dtype}")
        ms = timed(torch, lambda: knn_ops.knn_search(
            qc.data, ids[:N_SMALL], q, KC, scale=qc.scale, int8_dot=i8), 3)
        rate = I8_OPS if i8 else F32_OPS
        isz = qc.data.element_size()
        bms, by = bound(N_SMALL * (dp * isz + 8) + b * dp * (1 if i8 else 4)
                        + b * KC * 8, 2 * b * N_SMALL * dp, rate)
        log(f"[kernels] knn {dtype}{' int8-dot' if i8 else ''} N={N_SMALL}: "
            f"ok (max_abs_err {e:.3g}) ms={ms:.4f} bound_ms={bms:.4f} ({by})")
        del qc, vp, ip
        torch.cuda.empty_cache()


# ------------------------------------------------------------ main path
def serve(torch, corpus, streams, *, n_sessions, k_c, capacity, device,
          waves_seen=None):
    """Serve every session's turns through SessionManager, round by round,
    then one round re-asking each last turn.  Returns the engine."""
    import numpy as np

    from repro_torch.dist.retrieval import DeviceShard
    from repro_torch.serve.router import ShardedRouter
    from repro_torch.serve.session import BatchedEngine, SessionManager

    ids = torch.arange(corpus.shape[0], dtype=torch.int32, device=device)
    with ShardedRouter([DeviceShard(corpus, ids, device=device,
                                    dtype="fp32")], deadline_s=300) as router:
        engine = BatchedEngine(router, corpus, dim=DIM_RAW + 1,
                               n_sessions=n_sessions, k=K, k_c=k_c,
                               epsilon=EPS, capacity=capacity, dtype="fp32",
                               device=device)
        if waves_seen is not None:
            backend_wave = engine.backend_wave

            def counted(ws):
                waves_seen.append(bool(np.asarray(ws.need).any()))
                return backend_wave(ws)
            engine.backend_wave = counted
        rounds = [[s[t] for s in streams[:n_sessions]]
                  for t in range(streams[0].shape[0])]
        rounds.append([s[-1] for s in streams[:n_sessions]])
        with SessionManager(engine) as mgr:
            for key in range(n_sessions):
                mgr.open(key)
            for wave in rounds:
                futs = [mgr.submit(key, q) for key, q in enumerate(wave)]
                for f in futs:
                    f.result(timeout=600)
    return engine


def check_turns(engine, n_turns):
    import numpy as np
    for s, turns in enumerate(engine.turns):
        if len(turns) != n_turns:
            raise AssertionError(f"session {s}: {len(turns)} turns")
        for t in turns:
            if t.ids.shape != (K,) or not np.isfinite(t.scores).all() \
                    or (np.diff(t.scores) > 0).any():
                raise AssertionError(f"session {s}: malformed turn {t}")


def main_phase(torch, corpus, streams):
    import numpy as np

    from repro_torch.kernels import dispatch
    from repro_torch.kernels.knn import ref as knn_ref
    from repro_torch.kernels.parity import assert_topk_agree

    n_turns = streams[0].shape[0] + 1
    # small input first: the same engine on the card and on the CPU path
    small = [s[:4] for s in streams[:8]]
    world_docs = corpus[:60_000]
    kw = dict(n_sessions=8, k_c=100, capacity=1600)
    gpu = serve(torch, world_docs, small, device=DEV, **kw)
    cpu = serve(torch, world_docs.cpu(), small, device="cpu", **kw)
    for s in range(8):
        for a, b in zip(gpu.turns[s], cpu.turns[s]):
            if a.tier != b.tier:
                raise AssertionError(f"small input: session {s} tier "
                                     f"{a.tier} != {b.tier} on the CPU")
            assert_topk_agree(a.scores[None], a.ids[None], b.scores[None],
                              b.ids[None], SCORE_TOL, f"small session {s}")
    log(f"[main] small input (8 sessions x 5 turns, 60000 docs): card == "
        f"CPU path, hit rate {gpu.hit_rate():.4f}")
    del gpu, cpu
    torch.cuda.empty_cache()

    waves: list = []
    dispatch.reset_counters()
    t0 = time.perf_counter()
    engine = serve(torch, corpus, streams, n_sessions=S, k_c=KC,
                   capacity=CAPACITY, device=DEV, waves_seen=waves)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counters = dispatch.counters()
    miss, clean = sum(waves), len(waves) - sum(waves)
    # a CPU rehearsal launches nothing: it counts wrapper calls instead
    count = "launches" if DEV == "cuda" else "calls"
    got = {n: getattr(counters[n], count) for n in KERNELS}
    want = {"cache_probe": len(waves), "knn_score": miss, "knn_select": miss,
            "wave_insert_query": miss, "wave_query_topk": clean,
            "wave_insert_scatter": 0}
    if got != want or miss == 0 or clean == 0:
        raise AssertionError(f"launches {got} != {want} for {miss} waves "
                             f"with misses and {clean} without")
    ops = got["cache_probe"] + got["knn_score"] + got["wave_insert_query"] \
        + got["wave_query_topk"]
    if ops != 3 * miss + 2 * clean:
        raise AssertionError(f"{ops} launches for {miss} + {clean} waves")
    log(f"[main] {len(waves)} waves: {miss} with misses (3 launches each), "
        f"{clean} without (2 each); launches {got}")
    check_turns(engine, n_turns)
    # every miss turn answers the exact top-k of the whole corpus
    miss_q, miss_t = [], []
    for s, turns in enumerate(engine.turns):
        for t, turn in enumerate(turns):
            if turn.tier == "backend":
                miss_q.append(streams[s][min(t, n_turns - 2)])
                miss_t.append(turn)
    dp = corpus.shape[1]
    ids = torch.arange(corpus.shape[0], dtype=torch.int32, device=DEV)
    for lo in range(0, len(miss_q), 64):
        q = torch.nn.functional.pad(torch.as_tensor(
            np.stack(miss_q[lo:lo + 64]), device=DEV),
            (0, dp - DIM_RAW - 1))
        v, i = knn_ref.search(corpus, ids, q, K)
        got_v = np.stack([t.scores for t in miss_t[lo:lo + 64]])
        got_i = np.stack([t.ids for t in miss_t[lo:lo + 64]])
        assert_topk_agree(got_v, got_i, v, i, SCORE_TOL, "miss turns")
        torch.cuda.empty_cache()
    summ = engine.telemetry.summary()
    conv = [t.hit for turns in engine.turns for t in turns[1:-1]]
    log(f"[main] {S} sessions x {n_turns} turns over {corpus.shape[0]} docs "
        f"in {wall:.2f} s; {len(miss_t)} miss turns match the exact search; "
        f"hit rate {engine.hit_rate():.4f} (turns 2-10 of the conversations "
        f"alone: {np.mean(conv):.4f}); tiers {engine.tier_counts()}")
    log("[main] telemetry (s) " + json.dumps(
        {"turn": summ["spans"]["total_s"], "tiers": summ["tiers"],
         "wave_size": summ["wave_size"],
         "wave_service": summ["wave_service_s"]}))
    log(f"[main] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return counters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout holding src/repro_torch",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f" cuda {torch.version.cuda}")

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    report = _build.build_all(verbose=True)
    log(f"[build] {len(_build.SOURCES)} sources in "
        f"{time.perf_counter() - t0:.1f} s\n{report}")

    gen = torch.Generator(device=DEV)
    gen.manual_seed(args.seed)
    rep = Report()
    probe_phase(torch, rep, gen)
    wave_phase(torch, rep, gen)
    _world, corpus, streams = build_corpus(torch, args.seed)
    knn_phase(torch, rep, corpus, streams)
    counters = main_phase(torch, corpus, streams)
    print(rep.line(counters))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
