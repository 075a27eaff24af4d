"""The readers of the program's span log, and the labelling of a trace's
idle device time by the program's spans, against known answers."""

import threading

import pytest

from chipbench import program_spans, stats, trace
from chipbench.record import RunRecord
from chipbench.run import HERE, load_module
from chipbench.tests.test_chipbench_metrics import _E, _timeline

MS = 1_000_000


def reader(name):
    return load_module(HERE / "metrics" / f"{name}.py", "m_" + name)


def _reading_fields(r):
    return (r.window_s, r.busy_s, r.device_by_range, r.device_ops,
            r.idle_by_host)


def _with_spans():
    """The metric tests' timeline (device gaps at 0-5, 15-20, 35-55 and
    85-95 ms) with the program's spans, which lie on the host's timeline
    alone."""
    return _timeline() + [
        _E("serve.probe_wave", "CPU", 0, 40 * MS),
        _E("serve.encode", "CPU", 1 * MS, 16 * MS),
        _E("serve.sync.fill_ids", "CPU", 40 * MS, 50 * MS),
        _E("serve.fill_wave", "CPU", 38 * MS, 60 * MS),
        _E("serve.gc", "CPU", 86 * MS, 94 * MS)]


def test_read_events_is_blind_to_the_program_spans():
    assert _reading_fields(trace.read_events(_with_spans())) == \
        _reading_fields(trace.read_events(_timeline()))


def test_idle_by_span_labels_each_gap_with_the_shortest_span():
    by_span, pair = program_spans.idle_by_span(_with_spans())
    # gap midpoints: 2.5 (encode), 17.5 (probe_wave), 45 (the sync),
    # 90 (the collector); the copy clipped at the window ends at 95
    assert by_span == pytest.approx({"serve.encode": 0.005,
                                     "serve.probe_wave": 0.005,
                                     "serve.sync.fill_ids": 0.020,
                                     "serve.gc": 0.010})
    assert sum(by_span.values()) == pytest.approx(
        sum(trace.read_events(_timeline()).idle_by_host.values()))
    assert pair == pytest.approx({"cb.encoder | serve.encode": 0.005,
                                  "cb.encoder | serve.probe_wave": 0.005,
                                  "host | serve.sync.fill_ids": 0.020,
                                  "cb.knn | serve.gc": 0.010})
    by_span, _ = program_spans.idle_by_span(_timeline())
    assert by_span == pytest.approx({"none": 0.040})


@pytest.fixture
def span_log(monkeypatch):
    """A span log of two scripted waves and two requests, in place of the
    program's, on a clock of 1 ms a read."""
    from repro_torch.serve import telemetry

    class Clock:
        t = 0

        def __call__(self):
            Clock.t += MS
            return Clock.t

    monkeypatch.setattr(telemetry, "_clock", Clock())
    log = telemetry.SpanLog(capacity=256)
    k = {n: log.kind(n) for n in ("serve.probe_wave", "serve.encode",
                                  "serve.backend_wave", "serve.fill_wave")}
    sync = {n: log.kind(f"serve.sync.{n}", telemetry.SyncSite)
            for n in ("queries", "shard_ids", "fill_ids")}

    def tick(n):
        for _ in range(n):
            telemetry._clock()

    for w, extra in ((log.new_id(), 0), (log.new_id(), 3)):
        with k["serve.probe_wave"].of(w):
            with sync["queries"]:               # 1 ms
                pass
            with k["serve.encode"]:             # 2 + extra ms
                tick(1 + extra)
        with k["serve.backend_wave"].of(w):
            back = log.current()

        def pool():
            log.adopt(back)
            with sync["shard_ids"]:              # 3 ms, on another thread
                tick(2)
            log.adopt(-1)

        th = threading.Thread(target=pool)
        th.start()
        th.join()
        with k["serve.fill_wave"].of(w):
            for _ in range(1 + extra):          # (1 + extra) x 1 ms
                with sync["fill_ids"]:
                    pass
    for _ in range(2):                          # requests: encode, 4 ms
        with k["serve.encode"].of(log.new_id()):
            tick(3)
    monkeypatch.setattr(telemetry, "SPANS", log)
    return log, Clock


def test_span_readers_on_a_scripted_log(span_log):
    log, clock = span_log
    run = RunRecord(t_open=0.0, t_close=clock.t * 1e-9)
    assert reader("encode_ms.p50").read(run) == pytest.approx(
        stats.percentile([2, 5, 4, 4], 50))
    # wave 0: 1 + 3 + 1 ms in 3 syncs; wave 1: 1 + 3 + 4 ms in 6
    assert reader("syncs_per_wave.p50").read(run) == pytest.approx(4.5)
    assert reader("sync_wait_ms.p50").read(run) == pytest.approx(6.5)
    count, secs = program_spans.wave_syncs(program_spans.window(run))
    assert list(count) == [3, 6]
    assert secs * 1e3 == pytest.approx([5, 8])


def test_span_readers_read_nothing_where_nothing_is_held(span_log,
                                                         monkeypatch):
    log, clock = span_log
    late = RunRecord(t_open=(clock.t + 1) * 1e-9, t_close=1.0)
    assert reader("encode_ms.p50").read(late) is None
    assert reader("syncs_per_wave.p50").read(late) is None
    # a window the ring has overwritten reads None, not part of it
    small = type(log)(capacity=2)
    a = small.kind("serve.encode")
    for _ in range(3):
        with a:
            pass
    from repro_torch.serve import telemetry
    monkeypatch.setattr(telemetry, "SPANS", small)
    assert reader("encode_ms.p50").read(RunRecord(0.0, 1.0)) is None
    # a program without a span log (the parent of this reader)
    monkeypatch.delattr(telemetry, "SPANS")
    for name in ("encode_ms.p50", "sync_wait_ms.p50", "syncs_per_wave.p50"):
        assert reader(name).read(RunRecord(0.0, 1.0)) is None


@pytest.mark.parametrize("name", ["cast19-star.sessions", "sasrec.serve"])
def test_a_traced_run_labels_its_idle_time_by_span(tmp_path, name):
    import time

    from chipbench.tests import smoke

    root = smoke.smoke_root(tmp_path)
    out = program_spans.traced_run(smoke.smoke_cell(root, name), smoke.SEED,
                                   smoke.SMOKE_SECONDS[name], device="cpu",
                                   t_process=time.perf_counter())
    assert out["correct"]
    # on the CPU nothing runs on a device: the window is one idle gap,
    # labelled by the shortest span holding its midpoint
    by_span = dict(out["breakdown"]["idle_by_span"])
    assert len(by_span) == 1
    assert list(by_span)[0].startswith("serve.") or "none" in by_span
    assert sum(by_span.values()) == pytest.approx(out["device"]["window_s"],
                                                  rel=1e-6)
    assert set(out["end_to_end_traced"]) >= {"latency_p50_ms", "setup_s"}
    assert out["spans"]["spans"] > 0 and "serve.encode" in out["spans"]["ms"]
    assert "encode_ms.p50" in out["metrics"]
