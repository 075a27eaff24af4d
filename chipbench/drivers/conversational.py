"""Conversational search through the metric cache (``cast19-star``).

The system: the query encoder (``serve.engine.make_lm_query_encoder`` over
the configuration's transformer), the corpus behind one
``dist.retrieval.DeviceShard`` and a ``serve.router.ShardedRouter``, and
per-session metric caches, served either by ``serve.session.BatchedEngine``
behind ``SessionManager`` (entry "sessions": the front door, waves of
concurrent turns) or by ``serve.engine.ConversationalEngine`` (entry
"one_session": the paper's client, one conversation at a time).

Inputs, all from the seed (``chipbench.inputs``): the encoder's weights, a
pool of token scripts, and the corpus: around each distinct turn of the
pool, ``planted_per_centre`` documents are planted near the psi that the
reference encoder gives that turn; the rest are distractors.  Locality
therefore comes from the tokens the encoder sees, and the hit rate is
measured, not set.

The check (after the window, the program's state freed): for a sample of
the window's conversations, the program's psi against the reference
encoder's (``psi_gap``), each turn's hit decision against a plain replay
of the cache (``decision_flips``), and each answer against the replay's
(``answer_gap``: the widest gap by which an answered document scores below
the reference's document of the same rank; +inf for a document the
replay's cache does not hold).
"""

from __future__ import annotations

import collections
import gc
import queue
import threading
import time

import numpy as np
import torch

from chipbench import costs, inputs
from chipbench.drivers.common import Profiling, Timed, no_tf32, trace_span
from chipbench.load import EventLoop, conversation_plan, sample
from chipbench.record import Request, RunRecord
from chipbench.reference import cache as ref_cache
from chipbench.reference import encoder as ref_encoder
from chipbench.reference import full_f32
from chipbench.reference import knn as ref_knn

GRACE_S = 60.0          # a request due in the window may come this late
BAND = 1e-4             # |max r_hat - epsilon| within which a decision may tip

# the fields of ``serve.telemetry.TurnSpans`` the metric readers take
Span = collections.namedtuple(
    "Span", "queue_wait_s probe_s backend_s insert_s total_s tier")


class System:
    """The program as built for one run, and the benchmark's inputs."""

    def __init__(self, ctx, scripts, recipe):
        self.ctx, self.scripts, self.recipe = ctx, scripts, recipe
        self.encoder = None        # Timed around the program's encode
        self.knn = None            # Timed around the shard
        self.engine = None
        self.mgr = None
        self.router = None
        self.telemetry = None
        self.corpus = None


def _transformer_config(enc: dict):
    from repro_torch.models.transformer import TransformerConfig
    return TransformerConfig(
        name="cast19-star-encoder", n_layers=enc["n_layers"],
        d_model=enc["d_model"], n_heads=enc["n_heads"],
        n_kv_heads=enc["n_kv_heads"], d_head=enc["d_head"], d_ff=enc["d_ff"],
        vocab_size=enc["vocab_size"], rope_theta=enc["rope_theta"],
        norm_eps=enc["norm_eps"], tie_embeddings=True, dtype=torch.float32,
        q_chunk=enc["q_chunk"], kv_chunk=enc["kv_chunk"])


def _wave_log_class():
    from repro_torch.serve.telemetry import ServeTelemetry

    class WaveLog(ServeTelemetry):
        """The program's telemetry, also keeping every turn's spans grouped
        by wave (the scheduler records a wave right after its turns), as
        tuples of plain values, which the cyclic collector stops
        tracking."""

        def __init__(self):
            super().__init__()
            self.turn_buf: list = []
            self.wave_log: list = []

        def record_turn(self, spans) -> None:
            super().record_turn(spans)
            self.turn_buf.append(tuple(getattr(spans, f)
                                       for f in Span._fields))

        def record_wave(self, size: int, service_s: float) -> None:
            super().record_wave(size, service_s)
            self.wave_log.append({"t_end": time.perf_counter(), "size": size,
                               "service_s": service_s,
                               "spans": self.turn_buf})
            self.turn_buf = []

    return WaveLog


def centres_of(ctx, scripts, weights) -> torch.Tensor:
    """The reference encoder's psi of every distinct turn of the pool
    (raw part): where the corpus plants their documents."""
    tok = torch.as_tensor(scripts.unique_rows, device=ctx.device)
    with full_f32(), torch.no_grad():
        psi = ref_encoder.encode_rows(weights, tok, ctx.cfg["encoder"])
    return psi[:, :-1].contiguous()


def make_inputs(ctx):
    """The cell's inputs, all from the seed, for the program and for the
    control alike: the encoder's weights, the pool of token scripts, and
    the corpus recipe that plants documents around the reference psi of
    every distinct turn of the pool."""
    cfg = ctx.cfg
    weights = inputs.encoder_weights(cfg["encoder"], ctx.seed, ctx.device)
    scripts = inputs.token_scripts(cfg["scripts"],
                                   cfg["encoder"]["vocab_size"], ctx.seed)
    centres = centres_of(ctx, scripts, weights)
    n_scripts = scripts.unique.shape[0]
    centre_script = np.zeros(scripts.unique_rows.shape[0], np.int64)
    for c in range(n_scripts):
        centre_script[scripts.unique[c]] = c
    recipe = inputs.corpus_recipe(cfg, centres, centre_script, n_scripts,
                                  ctx.seed)
    return weights, scripts, recipe


def setup(ctx) -> System:
    from repro_torch.core.embedding import transform_documents
    from repro_torch.dist.retrieval import DeviceShard
    from repro_torch.serve import ConversationalEngine, ShardedRouter
    from repro_torch.serve.engine import make_lm_query_encoder
    from repro_torch.serve.session import BatchedEngine, SessionManager

    no_tf32()
    cfg, dev, log = ctx.cfg, ctx.device, ctx.log
    enc, cc, cache = cfg["encoder"], cfg["corpus"], cfg["cache"]
    t0 = time.perf_counter()
    weights, scripts, recipe = make_inputs(ctx)
    turns = scripts.unique.shape[1]
    t1 = time.perf_counter()
    dim = enc["out_dim"] + 1
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
    sysm.router = ShardedRouter([sysm.knn], deadline_s=GRACE_S,
                                hedge_after_s=GRACE_S, max_retries=0,
                                n_docs=cc["n_docs"])
    encode = make_lm_query_encoder(weights["params"],
                                   _transformer_config(enc),
                                   weights["proj"], device=dev)
    sysm.encoder = Timed(encode, "cb.encoder", ctx.tracer, keep=True)
    entry = ctx.traffic["entry"]
    kw = dict(dim=dim, k=cache["k"], k_c=cache["k_c"],
              epsilon=cache["epsilon"], capacity=cache["capacity"],
              dtype="fp32", device=dev)
    if entry == "sessions":
        sysm.telemetry = _wave_log_class()()
        slots = cfg["engine"]["n_sessions"]
        sysm.engine = BatchedEngine(sysm.router, corpus, n_sessions=slots,
                                    encoder=sysm.encoder,
                                    telemetry=sysm.telemetry, **kw)
        _wrap_phases(sysm.engine, ctx.tracer)
        warm_waves(sysm, _largest_wave(ctx))
        sysm.mgr = SessionManager(sysm.engine,
                                  max_slots=cfg["engine"]["max_wave"])
    elif entry == "one_session":
        sysm.engine = ConversationalEngine(
            sysm.router, corpus, encoder=lambda t: sysm.encoder(t[None])[0],
            **kw)
        for c in range(2):
            sysm.engine.start_session()
            for t in range(turns):
                sysm.engine.answer(scripts.rows[c, t])
    else:
        raise ValueError(f"entry {entry!r}: expected sessions or one_session")
    if dev != "cpu":
        torch.cuda.synchronize()
    sysm.encoder.reset()
    sysm.knn.reset()
    log(f"[setup] weights and {scripts.unique_rows.shape[0]} planted centres "
        f"in {t1 - t0:.2f} s; corpus {tuple(corpus.shape)} f32 "
        f"({corpus.numel() * 4 / 1e9:.2f} GB, M={m:.6f}) in {t2 - t1:.2f} s; "
        f"engine built and warmed in {time.perf_counter() - t2:.2f} s")
    return sysm


def _largest_wave(ctx) -> int:
    slots = min(ctx.cfg["engine"]["n_sessions"],
                ctx.cfg["engine"]["max_wave"])
    tr = ctx.traffic
    if tr["loop"] == "closed":
        return min(slots, int(tr["clients"]))
    return slots


def _wrap_phases(engine, tracer) -> None:
    """Benchmark ranges around the engine's three wave phases."""
    for phase in ("probe_wave", "backend_wave", "fill_wave"):
        fn = getattr(engine, phase)

        def wrapped(*a, _fn=fn, _name=f"cb.{phase}", **kw):
            with tracer.range(_name):
                return _fn(*a, **kw)

        setattr(engine, phase, wrapped)


def warm_waves(sysm, largest: int) -> None:
    """Every power-of-two wave up to ``largest``, once all misses and once
    all hits, through the engine's own wave path; the slots are reset
    after."""
    eng, rows = sysm.engine, sysm.scripts.rows
    b = 1
    while True:
        b = min(b, largest)
        sessions = list(range(b))
        for s in sessions:
            eng.start_session(s)
        queries = [rows[i % rows.shape[0], 0] for i in sessions]
        eng.answer_batch(sessions, queries)     # misses: the scan at B = b
        eng.answer_batch(sessions, queries)     # hits: probe -> query
        if b >= largest:
            break
        b *= 2
    for s in range(eng.n_sessions):
        eng.start_session(s)
    eng.telemetry.wave_log.clear()
    eng.telemetry.turn_buf.clear()


def fresh_front_door(sysm) -> None:
    """Every slot empty, a new ``SessionManager``, the logs cleared: the
    state ``setup`` leaves, for another window in the same process
    (``sweep.py``)."""
    from repro_torch.serve.session import SessionManager
    for s in range(sysm.engine.n_sessions):
        sysm.engine.start_session(s)
    sysm.telemetry.wave_log.clear()
    sysm.telemetry.turn_buf.clear()
    sysm.encoder.reset()
    sysm.knn.reset()
    sysm.mgr = SessionManager(sysm.engine,
                              max_slots=sysm.ctx.cfg["engine"]["max_wave"])


# ------------------------------------------------------------------- serve
def serve(sysm, ctx) -> RunRecord:
    if ctx.traffic["entry"] == "sessions":
        return _serve_sessions(sysm, ctx)
    return _serve_one_session(sysm, ctx)


def _serve_sessions(sysm, ctx) -> RunRecord:
    """The front door under the mix's load.  The event loop (this thread)
    sends each turn when it is due; a second thread opens and closes
    sessions (``SessionManager.open`` resets a slot's cache on the
    device), so that one conversation's open never holds up another's
    turn.  A conversation that finds no free slot waits in the admission
    queue, and that wait counts in its first turn's latency.

    While the load runs the benchmark keeps each answered turn as a tuple
    of plain values and numpy arrays, which the cyclic collector stops
    tracking, and no future past its answer: its own records never add to
    a pass of the collector, which holds up the program's threads too.
    They become ``Request`` records once the window has closed."""
    tr, scripts = ctx.traffic, sysm.scripts
    mgr, slots = sysm.mgr, sysm.engine.n_sessions
    horizon = tr["ramp_s"] + ctx.seconds + GRACE_S
    plan = conversation_plan(tr, scripts.rows.shape[0], horizon, ctx.seed,
                             tr["ramp_s"] + ctx.seconds)
    sysm.plan_scripts = plan.scripts
    admin: queue.SimpleQueue = queue.SimpleQueue()
    lock = threading.Lock()
    t_start = time.perf_counter()
    rec = RunRecord(t_open=t_start + tr["ramp_s"],
                    t_close=t_start + tr["ramp_s"] + ctx.seconds)
    prof = Profiling(ctx.tracer, *trace_span(ctx, rec.t_open))
    waiting: collections.deque = collections.deque()
    state = {"open": 0, "pending": 0, "next": 0, "stopping": False,
             "peak_open": 0, "peak_waiting": 0}
    due_of: dict = {}       # (conversation, turn) -> due, until answered
    answered: list = []     # (conv, turn, due, done, ok, hit, answer)
    in_flight: set = set()  # futures not yet resolved

    def new_request(c: int, t: int, due: float) -> None:
        with lock:
            due_of[c, t] = due
            if rec.in_window(due):
                state["pending"] += 1

    def submit(c: int, t: int) -> None:
        fut = mgr.submit(c, scripts.rows[plan.scripts[c], t])
        in_flight.add(fut)

        def on_done(f, _c=c, _t=t):
            t_done = time.perf_counter()
            in_flight.discard(f)
            loop.post(lambda: finished(_c, _t, f, t_done))

        fut.add_done_callback(on_done)

    def arrive(c: int, due: float) -> None:
        new_request(c, 0, due)
        admin.put(("arrive", c))

    def finished(c: int, t: int, fut, t_done: float) -> None:
        with lock:
            due = due_of.pop((c, t))
            if rec.in_window(due):
                state["pending"] -= 1
        exc = fut.exception()
        if exc is None:
            turn = fut.result()
            answered.append((c, t, due, t_done, not turn.degraded,
                             bool(turn.hit), (turn.ids, turn.scores)))
        else:
            answered.append((c, t, due, t_done, False, None, repr(exc)))
        if exc is None and t + 1 < plan.turns and not state["stopping"]:
            nxt = t_done + float(plan.think[c, t + 1])
            loop.at(nxt, c, t + 1)
        else:
            admin.put(("close", c))

    def act(due: float, c: int, t: int) -> None:
        """A timed action: conversation ``c`` arrives (``t`` 0) or its
        turn ``t`` is due."""
        if t == 0:
            arrive(c, due)
        else:
            new_request(c, t, due)
            submit(c, t)

    loop = EventLoop(act)

    def open_(c: int) -> None:
        mgr.open(c)
        with lock:
            state["open"] += 1
            state["peak_open"] = max(state["peak_open"], state["open"])
        submit(c, 0)

    def start_next(now: float) -> None:
        with lock:
            c = state["next"]
            state["next"] += 1
        arrive(c, now)

    def administer() -> None:
        while True:
            item = admin.get()
            if item is None:
                return
            kind, c = item
            if kind == "arrive":
                if state["open"] < slots:
                    open_(c)
                else:
                    waiting.append(c)
                    state["peak_waiting"] = max(state["peak_waiting"],
                                                len(waiting))
                continue
            mgr.close(c)
            with lock:
                state["open"] -= 1
            if state["stopping"]:
                continue
            if waiting:
                open_(waiting.popleft())
            if plan.arrivals is None:
                start_next(time.perf_counter())

    admin_thread = threading.Thread(target=administer, name="cb-admin",
                                    daemon=True)
    admin_thread.start()
    if plan.arrivals is None:
        for _ in range(plan.clients):
            start_next(t_start)
    else:
        for c, a in enumerate(plan.arrivals):
            if a > horizon:
                break
            state["next"] = c + 1
            loop.at(t_start + a, c, 0)

    def done() -> bool:
        now = time.perf_counter()
        prof.tick(now)
        if now < rec.t_close:
            return False
        return state["pending"] == 0 or now > rec.t_close + GRACE_S

    loop.run(done)
    prof.stop()
    state["stopping"] = True
    t_end = time.perf_counter()
    # stop offering load; let what is in flight finish
    for fut in list(in_flight):
        try:
            fut.exception(timeout=GRACE_S)
        except Exception:                          # noqa: BLE001
            pass
    admin.put(None)
    admin_thread.join(timeout=GRACE_S)
    mgr.shutdown()
    with lock:
        for c, t, due, t_done, ok, hit, answer in answered:
            rec.requests.append(Request(
                due=due, done=t_done, ok=ok, hit=hit, turn=t, conv=c,
                measured=rec.in_window(due), answer=answer))
        for (c, t), due in due_of.items():          # never answered
            rec.requests.append(Request(due=due, turn=t, conv=c,
                                        measured=rec.in_window(due)))
    rec.trace = ctx.tracer.read()
    rec.notes.update(
        conversations_started=state["next"], peak_open=state["peak_open"],
        peak_waiting=state["peak_waiting"],
        lateness_p99_ms=_p(loop.lateness, 99) * 1e3,
        drain_s=t_end - rec.t_close)
    _collect_waves(sysm, rec)
    return rec


def _p(xs, q) -> float:
    return float(np.percentile(xs, q)) if len(xs) else 0.0


def _collect_waves(sysm, rec: RunRecord) -> None:
    """Waves that ended inside the window, their turns' spans, and the
    window's model flops and service seconds."""
    intervals = []
    for w in sysm.telemetry.wave_log:
        if rec.in_window(w["t_end"]):
            w["spans"] = [Span(*s) for s in w["spans"]]
            rec.waves.append(w)
            rec.spans.extend(w["spans"])
            intervals.append((w["t_end"] - w["service_s"], w["t_end"]))
    from chipbench.stats import covered
    rec.service_s = covered(intervals, rec.t_open, rec.t_close)
    sizes = [w["size"] for w in rec.waves]
    rec.notes.update(waves=len(sizes), wave_turns_p50=_p(sizes, 50),
                     wave_turns_max=max(sizes, default=0))
    rec.model_flops = _window_flops(sysm, rec)
    rec.calls = {"encoder": _encoder_calls(sysm), "knn": list(sysm.knn.calls)}


def _encoder_calls(sysm) -> list:
    """The encoder's calls, each with the operations of the rows it was
    handed (their real tokens)."""
    enc = sysm.ctx.cfg["encoder"]
    out = []
    for call, (args, _psi) in zip(sysm.encoder.calls, sysm.encoder.kept):
        tok = np.asarray(torch.as_tensor(args[0]).cpu())
        call.flops = costs.encoder_flops(enc, (tok >= 0).sum(-1).ravel())
        out.append(call)
    return out


def _window_flops(sysm, rec: RunRecord) -> float:
    """Model flops of the turns answered in the window: the encoder over
    each turn's tokens, and a corpus scan for each miss."""
    cfg = sysm.ctx.cfg
    cc, enc = cfg["corpus"], cfg["encoder"]
    scan = costs.knn_search(1, cc["n_docs"], enc["out_dim"] + 1,
                            cc["stored_width"], cfg["cache"]["k_c"])[0]
    total = 0.0
    for r in rec.requests:
        if r.ok and rec.in_window(r.done):
            n = int(sysm.scripts.lengths[_script(sysm, r), r.turn])
            total += costs.encoder_flops(enc, [n])
            if not r.hit:
                total += scan
    return total


def _script(sysm, req: Request) -> int:
    return int(sysm.plan_scripts[req.conv])


def _serve_one_session(sysm, ctx) -> RunRecord:
    tr, scripts, eng = ctx.traffic, sysm.scripts, sysm.engine
    horizon = tr["ramp_s"] + ctx.seconds + GRACE_S
    plan = conversation_plan(tr, scripts.rows.shape[0], horizon, ctx.seed,
                             tr["ramp_s"] + ctx.seconds)
    sysm.plan_scripts = plan.scripts
    t_start = time.perf_counter()
    rec = RunRecord(t_open=t_start + tr["ramp_s"],
                    t_close=t_start + tr["ramp_s"] + ctx.seconds)
    prof = Profiling(ctx.tracer, *trace_span(ctx, rec.t_open))
    c, busy = 0, []
    while time.perf_counter() <= rec.t_close:
        eng.start_session()
        for t in range(plan.turns):
            prof.tick()
            due = time.perf_counter()
            req = Request(due=due, turn=t, conv=c,
                          measured=rec.t_open <= due <= rec.t_close)
            rec.requests.append(req)
            try:
                with ctx.tracer.range("cb.answer"):
                    turn = eng.answer(scripts.rows[plan.scripts[c], t])
            except Exception as e:                 # noqa: BLE001
                req.done, req.answer = time.perf_counter(), repr(e)
                break
            req.done = time.perf_counter()
            req.ok, req.hit = not turn.degraded, bool(turn.hit)
            req.answer = (turn.ids, turn.scores)
            busy.append((due, req.done))
        c += 1
    prof.stop()
    rec.trace = ctx.tracer.read()
    from chipbench.stats import covered
    rec.service_s = covered(busy, rec.t_open, rec.t_close)
    rec.model_flops = _window_flops(sysm, rec)
    rec.calls = {"encoder": _encoder_calls(sysm), "knn": list(sysm.knn.calls)}
    rec.notes.update(conversations_started=c)
    return rec


# -------------------------------------------------------------- release
def release(sysm) -> None:
    """Free the program's state: engine, caches, router, corpus."""
    if sysm.router is not None:
        sysm.router.close()
    sysm.engine = sysm.mgr = sysm.router = sysm.corpus = None
    sysm.telemetry = None
    gc.collect()
    if sysm.ctx.device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- check
def sampled_conversations(sysm, rec: RunRecord) -> list:
    """Conversations with a turn due in the window and every turn
    answered, ``sample`` of them drawn from the seed: [[requests by
    turn]]."""
    by_conv: dict = collections.defaultdict(list)
    for r in rec.requests:
        by_conv[r.conv].append(r)
    turns = int(sysm.ctx.traffic["turns"])
    full = [c for c, rs in sorted(by_conv.items())
            if len(rs) == turns and all(r.ok for r in rs)
            and any(r.measured for r in rs)]
    pick = sample(full, int(sysm.ctx.traffic["sample"]), sysm.ctx.seed,
                  "check")
    return [sorted(by_conv[c], key=lambda r: r.turn) for c in pick]


def program_psi(sysm, need: set) -> dict:
    """{distinct row: (n, dim) every psi the program's encoder gave that
    row in the run}, from the encoder calls the run kept."""
    rows = sysm.scripts.unique_rows
    key_of = {rows[u].tobytes(): u for u in need}
    found: dict = collections.defaultdict(list)
    for args, psi in sysm.encoder.kept:
        tok = np.asarray(torch.as_tensor(args[0]).cpu()).reshape(
            -1, rows.shape[1])
        psi = psi.reshape(-1, psi.shape[-1])
        for i, row in enumerate(tok):
            u = key_of.get(row.tobytes())
            if u is not None:
                found[u].append(psi[i])
    return {u: torch.stack(v).detach().float() for u, v in found.items()}


def program_outputs(sysm, rec: RunRecord):
    """The sampled conversations as [(distinct row, hit, answer ids) by
    turn], and the psi the program gave each of their rows."""
    uniq, script_of = sysm.scripts.unique, sysm.plan_scripts
    convs = [[(int(uniq[script_of[r.conv], r.turn]), bool(r.hit),
               np.asarray(r.answer[0])) for r in rs]
             for rs in sampled_conversations(sysm, rec)]
    need = {u for turns in convs for u, _, _ in turns}
    return convs, program_psi(sysm, need)


def compare(ctx, scripts, recipe, convs: list, psi: dict) -> dict:
    """{number: value}: the answers ``convs`` and the ``psi`` of their
    rows (every psi the program gave a row) held against the reference in
    float32."""
    cfg, dev = ctx.cfg, ctx.device
    if not convs:
        raise RuntimeError("no conversation of the window to check")
    need = sorted(psi)
    pos = {u: i for i, u in enumerate(need)}
    tok = torch.as_tensor(scripts.unique_rows[need], device=dev)
    with full_f32(), torch.no_grad():
        weights = inputs.encoder_weights(cfg["encoder"], ctx.seed, dev)
        psi_ref = ref_encoder.encode_rows(weights, tok, cfg["encoder"])
        del weights
        psi_gap = max(float((psi[u].to(dev).float().reshape(
            -1, psi_ref.shape[1]) - psi_ref[pos[u]]).abs().max())
            for u in need)
        top_s, top_i = ref_knn.corpus_topk(recipe, psi_ref,
                                           cfg["cache"]["k_c"])
        union = torch.unique(top_i)
        docs = ref_knn.corpus_rows(recipe, union)
        row_of = {int(d): j for j, d in enumerate(union.tolist())}
        flips = border = 0
        gap = 0.0
        for turns in convs:
            idx = [pos[u] for u, _, _ in turns]
            checks = ref_cache.replay(
                psi_ref[idx], np.array([h for _, h, _ in turns]),
                [ids for _, _, ids in turns], top_s[idx], top_i[idx], docs,
                row_of, cache_config(cfg), BAND)
            flips += sum(c.flip for c in checks)
            border += sum(c.borderline for c in checks)
            gap = max(gap, max(c.answer_gap for c in checks))
    ctx.log(f"[check] {len(convs)} conversations, "
            f"{sum(map(len, convs))} turns, {len(need)} distinct rows; "
            f"{border} decisions within {BAND} of epsilon followed the "
            f"program")
    return {"psi_gap": psi_gap, "decision_flips": float(flips),
            "answer_gap": gap}


def cache_config(cfg: dict) -> dict:
    return dict(cfg["cache"], max_queries=cfg["cache"].get("max_queries",
                                                           64))


def check(sysm, rec: RunRecord, ctx) -> dict:
    convs, psi = program_outputs(sysm, rec)
    return compare(ctx, sysm.scripts, sysm.recipe, convs, psi)


def control(ctx) -> dict:
    """The check's numbers with the reference at TF32 in the program's
    place: as many conversations as a run compares, drawn from the seed
    among the pool's scripts, each served by a plain replay of its cache
    over the TF32 encoder's psi and the TF32 scan's top k_c."""
    weights, scripts, recipe = make_inputs(ctx)
    cfg, dev = ctx.cfg, ctx.device
    n_turns = int(ctx.traffic["turns"])
    pick = sample(range(scripts.unique.shape[0]), int(ctx.traffic["sample"]),
                  ctx.seed, "check")
    need = sorted({int(scripts.unique[c, t]) for c in pick
                   for t in range(n_turns)})
    pos = {u: i for i, u in enumerate(need)}
    tok = torch.as_tensor(scripts.unique_rows[need], device=dev)
    with full_f32(), torch.no_grad():
        psi = ref_encoder.encode_rows(weights, tok, cfg["encoder"], "tf32")
        del weights
        top_s, top_i = ref_knn.corpus_topk(recipe, psi, cfg["cache"]["k_c"],
                                           "tf32")
        union = torch.unique(top_i)
        docs = ref_knn.corpus_rows(recipe, union)
        row_of = {int(d): j for j, d in enumerate(union.tolist())}
        convs = []
        for c in pick:
            idx = [pos[int(scripts.unique[c, t])] for t in range(n_turns)]
            served = ref_cache.serve(psi[idx], top_s[idx], top_i[idx], docs,
                                     row_of, cache_config(cfg), "tf32")
            convs.append([(int(scripts.unique[c, t]), hit, ids)
                          for t, (hit, ids) in enumerate(served)])
        del docs
    return compare(ctx, scripts, recipe, convs,
                   {u: psi[pos[u]] for u in need})
