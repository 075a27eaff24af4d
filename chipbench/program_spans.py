"""The program's own spans: the serving path records each layer boundary
into its span log (``repro_torch.serve.telemetry.SPANS``; names start with
``serve.``, a blocking host<->device copy is ``serve.sync.<site>``, a pass
of Python's collector ``serve.gc``).  This module reads them for the
metric readers, and labels a traced run's idle device time with them.

  * ``window(run)``: the spans that began in the run's window, or None
    where the program keeps no span log or the log no longer holds the
    whole window;
  * ``wave_syncs(spans)``: for each wave whose probe phase began in the
    window, how many sync spans carry its id and their seconds;
  * ``idle_by_span(events)``: from a profiler trace's events, the idle
    device seconds of each gap between device activities, labelled with
    the shortest ``serve.*`` span on any thread that holds the gap's
    midpoint (``none`` where no span does), the rule ``chipbench.trace``
    labels the benchmark's ranges by; and the same seconds by the pair of
    the benchmark range and the span.

    python -m chipbench.program_spans --workload <cell> --seed <n> \\
        --seconds <s>

runs one traced run of a cell as ``chipbench.run --trace 1`` does and
prints its result line with ``breakdown.idle_by_span``,
``breakdown.idle_by_range_and_span``, the log's span counts and the
run's end-to-end metrics added (``traced_run``).
"""

from __future__ import annotations

import bisect
import sys

import numpy as np

from chipbench import stats


def window(run):
    """The program's spans that began inside ``[run.t_open,
    run.t_close]``, or None."""
    try:
        from repro_torch.serve import telemetry
    except ImportError:
        return None
    log = getattr(telemetry, "SPANS", None)
    if log is None:
        return None
    return log.window(int(round(run.t_open * 1e9)),
                      int(round(run.t_close * 1e9)))


def durations_ms(spans, name: str) -> np.ndarray:
    """Milliseconds of every closed span named ``name``."""
    return spans.seconds()[spans.of(name)] * 1e3


def wave_syncs(spans) -> tuple[np.ndarray, np.ndarray]:
    """(count, seconds) of the ``serve.sync.*`` spans of each wave whose
    ``serve.probe_wave`` span began in the window, on every thread."""
    waves = np.unique(spans.wave[spans.of("serve.probe_wave")
                                 & (spans.wave >= 0)])
    sync = spans.of("serve.sync.") & np.isin(spans.wave, waves)
    pos = np.searchsorted(waves, spans.wave[sync])
    return (np.bincount(pos, minlength=len(waves)),
            np.bincount(pos, weights=spans.seconds()[sync],
                        minlength=len(waves)))


def idle_by_span(events) -> tuple[dict, dict]:
    """({span: idle device seconds}, {"<range> | <span>": seconds}) of a
    trace's ``cb.window``, from the profiler's events."""
    window = None
    device, host, ranges = [], [], []
    for e in events:
        name = e.name()
        on_host = str(e.device_type()).endswith("CPU")
        if name == "cb.window":
            if on_host:
                window = (e.start_ns(), e.end_ns())
        elif name.startswith("serve."):
            if on_host:
                host.append((e.start_ns(), e.end_ns(), name))
        elif name.startswith("cb."):
            if on_host:
                ranges.append((e.start_ns(), e.end_ns(),
                               name.split("#", 1)[0]))
        elif not on_host:
            device.append((e.start_ns(), e.end_ns()))
    if window is None:
        raise RuntimeError("the trace holds no cb.window range")
    lo, hi = window
    gap_list = stats.gaps(((max(s, lo), min(t, hi)) for s, t in device
                           if t > lo and s < hi), lo, hi)
    spans = _label(gap_list, host)
    rng = _label(gap_list, ranges)
    by_span: dict = {}
    pair: dict = {}
    for (g0, g1), s, r in zip(gap_list, spans, rng):
        sec = (g1 - g0) / 1e9
        s = s or "none"
        by_span[s] = by_span.get(s, 0.0) + sec
        key = f"{r or 'host'} | {s}"
        pair[key] = pair.get(key, 0.0) + sec
    return by_span, pair


def _label(gap_list: list, spans: list) -> list:
    """The name of the shortest span holding each gap's midpoint."""
    mids = [(g0 + g1) / 2 for g0, g1 in gap_list]
    best: list = [None] * len(gap_list)
    for s, t, n in spans:
        for i in range(bisect.bisect_left(mids, s),
                       bisect.bisect_right(mids, t)):
            if best[i] is None or t - s < best[i][1] - best[i][0]:
                best[i] = (s, t, n)
    return [b[2] if b else None for b in best]


def span_counts() -> dict:
    """Spans the log holds: in all, of each wave or request (median), all
    of them over the waves and requests, and each name's count and
    p50/p95 in ms."""
    from repro_torch.serve import telemetry
    if not hasattr(telemetry, "SPANS"):
        return {}
    sp = telemetry.SPANS.all()
    ids, per = np.unique(sp.wave[sp.wave >= 0], return_counts=True)
    return {"spans": int(len(sp.token)), "waves_and_requests": int(len(ids)),
            "per_wave_p50": stats.percentile(per, 50),
            "all_over_waves": len(sp.token) / max(len(ids), 1),
            "ms": {n: [v["count"], v["p50"] * 1e3, v["p95"] * 1e3]
                   for n, v in telemetry.SPANS.summary().items()}}


def traced_run(cell, seed: int, seconds: float, **kw) -> dict:
    """One run of ``cell`` with tracing on, as ``chipbench.run`` makes it
    (``kw`` goes to ``run.run_cell``);
    its result adds ``breakdown.idle_by_span``,
    ``breakdown.idle_by_range_and_span``, ``spans`` (``span_counts``) and
    ``end_to_end_traced`` (the cell's end-to-end metrics of this traced
    run, to set beside untraced runs)."""
    from chipbench import run as harness
    from chipbench import trace

    found: dict = {}
    read, driver = trace.read_events, cell.driver

    def read_events(events):
        events = list(events)
        found["by_span"], found["pair"] = idle_by_span(events)
        return read(events)

    def capturing_driver():
        mod = driver()
        serve = mod.serve

        def serve_and_keep(system, ctx):
            found["run"] = serve(system, ctx)
            return found["run"]

        mod.serve = serve_and_keep
        return mod

    trace.read_events, cell.driver = read_events, capturing_driver
    try:
        out = harness.run_cell(cell, seed, seconds, True, **kw)
    finally:
        trace.read_events, cell.driver = read, driver
    if "by_span" in found and "breakdown" in out:
        out["breakdown"]["idle_by_span"] = trace.top(found["by_span"], 30)
        out["breakdown"]["idle_by_range_and_span"] = trace.top(
            found["pair"], 40)
    out["spans"] = span_counts()
    run = found.get("run")
    if run is not None:
        e2e = {}
        for m in cell.metrics(False):
            v = cell.reader(m["name"]).read(run)
            if v is not None:
                e2e[m["name"]] = float(v)
        out["end_to_end_traced"] = e2e
    return out


def main(argv=None) -> int:
    import argparse
    import json

    from chipbench import run as harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    cell = harness.Cell(harness.load_json(harness.ROOT / "BENCHMARK.json"),
                        args.workload)
    harness.cache_dirs(harness.ROOT)
    sys.path.insert(0, str(harness.ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(json.dumps(traced_run(cell, args.seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
