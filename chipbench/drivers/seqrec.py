"""Sequential recommendation through the index scan (``sasrec``).

The system: ``models.recsys.SeqRec`` with the benchmark's weights, whose
``retrieve(items, k)`` encodes each history (``seqrec_session_repr``) and
answers it with the top k of its item table through
``candidate_index`` -> ``MetricIndex.search`` -> the kNN kernels.  One
client sends requests of ``batch`` histories back to back; a request is
done when its scores and ids are on the host.

The check (after the window): for ``sample`` requests drawn from the seed,
the reference encodes the same histories and takes the exact top k of the
item table; ``score_err`` is the largest difference between a score the
program returned and the reference's score of the same item, and
``answer_gap`` the widest gap by which a returned item scores below the
reference's item of the same rank (+inf for a repeated or invalid id).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from chipbench import costs, inputs
from chipbench.drivers.common import Profiling, Timed, no_tf32, trace_span
from chipbench.load import sample
from chipbench.record import Request, RunRecord
from chipbench.reference import full_f32
from chipbench.reference import seqrec as ref_seqrec


class System:
    def __init__(self, ctx, pool):
        self.ctx, self.pool = ctx, pool
        self.model = None
        self.knn = None
        self.encode = None
        self.device_pool = None


def model_config(cfg: dict):
    from repro_torch.models.recsys import SeqRecConfig
    m = cfg["model"]
    return SeqRecConfig(name=cfg["name"], vocab=m["vocab"],
                        max_len=m["max_len"], embed_dim=m["embed_dim"],
                        n_blocks=m["n_blocks"], n_heads=m["n_heads"],
                        causal=True, d_ff_mult=m["d_ff_mult"],
                        dtype=torch.float32)


def _load(dst, src) -> None:
    """Copy the benchmark's weights into the program's parameter tree."""
    if isinstance(dst, dict):
        for k in dst:
            _load(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _load(d, s)
    else:
        dst.copy_(src)


def make_inputs(ctx):
    """The cell's inputs, from the seed, for the program and for the
    control alike: the model's weights on the device and the pool of
    requests (item histories, -1 padded)."""
    m = ctx.cfg["model"]
    return (inputs.seqrec_weights(m, ctx.seed, ctx.device),
            inputs.histories(ctx.traffic, m["vocab"], m["max_len"],
                             ctx.seed))


def setup(ctx) -> System:
    from repro_torch.models.recsys import SeqRec

    no_tf32()
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    m = cfg["model"]
    t0 = time.perf_counter()
    weights, pool = make_inputs(ctx)
    model = SeqRec(model_config(cfg), device=dev,
                   generator=inputs.generator(ctx.seed, "unused",
                                              device=dev))
    with torch.no_grad():
        _load(model.params, weights)
    del weights
    sysm = System(ctx, pool)
    sysm.model = model
    k = int(tr["k"])
    d, dp = m["embed_dim"], m["stored_width"]
    index = model.index(None)

    def knn_work(args, out):
        return costs.knn_search(int(args[0].shape[0]), m["vocab"], d, dp,
                                int(args[1]))

    sysm.knn = Timed(index.search, "cb.knn", ctx.tracer, knn_work)
    index.search = sysm.knn
    sysm.encode = Timed(model.session_repr, "cb.encode", ctx.tracer)
    model.session_repr = sysm.encode
    for i in range(2):
        s, ids = model.retrieve(pool[i], k)
        s.cpu(), ids.cpu()
    if dev != "cpu":
        torch.cuda.synchronize()
    sysm.knn.reset()
    sysm.encode.reset()
    ctx.log(f"[setup] SASRec ({m['vocab']} items, d {d}) and "
            f"{pool.shape[0]} requests of {pool.shape[1]} histories in "
            f"{time.perf_counter() - t0:.2f} s")
    return sysm


def serve(sysm, ctx) -> RunRecord:
    tr, model, pool = ctx.traffic, sysm.model, sysm.pool
    k = int(tr["k"])
    t_start = time.perf_counter()
    rec = RunRecord(t_open=t_start + tr["ramp_s"],
                    t_close=t_start + tr["ramp_s"] + ctx.seconds)
    prof = Profiling(ctx.tracer, *trace_span(ctx, rec.t_open))
    n, busy = 0, []
    keep = set(sample(range(tr["sample_among"]), int(tr["sample"]),
                      ctx.seed, "check"))
    first_measured = None
    while time.perf_counter() <= rec.t_close:
        prof.tick()
        due = time.perf_counter()
        req = Request(due=due, conv=n, measured=rec.t_open <= due)
        rec.requests.append(req)
        items = pool[n % pool.shape[0]]
        try:
            with ctx.tracer.range("cb.request"):
                s, ids = model.retrieve(items, k)
                s, ids = s.cpu().numpy(), ids.cpu().numpy()
        except Exception as e:                     # noqa: BLE001
            req.done, req.answer = time.perf_counter(), repr(e)
            n += 1
            continue
        req.done, req.ok = time.perf_counter(), True
        if req.measured:
            if first_measured is None:
                first_measured = n
            if n - first_measured in keep:
                req.answer = (s, ids)
        busy.append((due, req.done))
        n += 1
    prof.stop()
    rec.trace = ctx.tracer.read()
    from chipbench.stats import covered
    rec.service_s = covered(busy, rec.t_open, rec.t_close)
    m = ctx.cfg["model"]
    for r in rec.requests:
        if r.ok and rec.in_window(r.done):
            lens = (pool[r.conv % pool.shape[0]] >= 0).sum(1)
            rec.model_flops += costs.seqrec_flops(
                m["embed_dim"], m["n_blocks"], m["d_ff_mult"], lens,
                m["vocab"])
    rec.calls = {"knn": list(sysm.knn.calls)}
    rec.notes.update(requests=n, pool=pool.shape[0])
    return rec


def release(sysm) -> None:
    sysm.model = None
    gc.collect()
    if sysm.ctx.device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def compare(ctx, items: np.ndarray, prog_scores: np.ndarray,
            prog_ids: np.ndarray) -> dict:
    """{number: value}: returned (scores, ids) (B, k) of histories
    ``items`` (B, S) held against the reference in float32."""
    cfg, dev = ctx.cfg, ctx.device
    k = prog_ids.shape[1]
    with full_f32(), torch.no_grad():
        w = inputs.seqrec_weights(cfg["model"], ctx.seed, dev)
        q = ref_seqrec.session_repr(w, torch.as_tensor(items, device=dev),
                                    cfg["model"])
        ref_s, _ref_i = ref_seqrec.topk(w, q, k)
        ids = torch.as_tensor(prog_ids, device=dev).long()
        valid = (ids >= 0) & (ids < cfg["model"]["vocab"])
        mine = ref_seqrec.scores_of(w, q, ids)
    score_err = float((torch.as_tensor(prog_scores, device=dev)
                       - mine).abs().max())
    gap = (ref_s - mine).max(dim=1).values
    srt = ids.sort(dim=1).values
    repeated = (srt[:, 1:] == srt[:, :-1]).any(dim=1)
    bad = repeated | ~valid.all(dim=1)
    gap = torch.where(bad, torch.full_like(gap, float("inf")), gap)
    return {"score_err": score_err, "answer_gap": float(gap.max())}


def check(sysm, rec: RunRecord, ctx) -> dict:
    kept = [r for r in rec.requests if r.answer is not None and r.ok]
    if not kept:
        raise RuntimeError("no request of the window to check")
    items = np.concatenate([sysm.pool[r.conv % sysm.pool.shape[0]]
                            for r in kept])
    s = np.concatenate([r.answer[0] for r in kept])
    ids = np.concatenate([r.answer[1] for r in kept])
    ctx.log(f"[check] {len(kept)} requests, {items.shape[0]} histories")
    return compare(ctx, items, s, ids)


def control(ctx) -> dict:
    """The check's numbers with the reference at TF32 in the program's
    place, over as many requests as a run compares, drawn from the seed."""
    weights, pool = make_inputs(ctx)
    m = ctx.cfg["model"]
    pick = sample(range(pool.shape[0]), int(ctx.traffic["sample"]),
                  ctx.seed, "check")
    items = np.concatenate([pool[i] for i in pick])
    with full_f32(), torch.no_grad():
        q = ref_seqrec.session_repr(
            weights, torch.as_tensor(items, device=ctx.device), m, "tf32")
        s, ids = ref_seqrec.topk(weights, q, int(ctx.traffic["k"]), "tf32")
        s = ref_seqrec.scores_of(weights, q, ids, "tf32")
    del weights
    return compare(ctx, items, s.cpu().numpy(), ids.cpu().numpy())
