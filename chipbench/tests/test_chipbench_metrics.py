"""The metric arithmetic against known answers."""

import math

import pytest

from chipbench import costs, hardware, stats, trace
from chipbench.record import Call, Request, RunRecord
from chipbench.run import load_module, HERE


def reader(name):
    return load_module(HERE / "metrics" / f"{name}.py", "m_" + name)


def test_percentile_is_numpys_linear_rule():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert stats.percentile(xs, 50) == 3.0
    assert stats.percentile(xs, 95) == pytest.approx(4.8)
    assert stats.percentile([], 50) is None


def test_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([10, 10, 10, 10, 10, 10]) == 0.0
    v = [90, 95, 100, 100, 105, 110]
    q1, med, q3 = 93.75, 100.0, 106.25
    assert stats.spread(v) == pytest.approx((q3 - q1) / med)


def _run():
    run = RunRecord(t_open=10.0, t_close=20.0, setup_s=3.5)
    # 20 requests due in the window, latency 1..20 ms; one failed; two
    # due outside; hits on later turns
    for i in range(20):
        run.requests.append(Request(due=10.0 + i * 0.4,
                                    done=10.0 + i * 0.4 + (i + 1) / 1e3,
                                    ok=i != 7, measured=True, turn=i % 3,
                                    hit=i % 2 == 0))
    run.requests.append(Request(due=9.0, done=10.5, ok=True))
    run.requests.append(Request(due=20.5, done=21.0, ok=True))
    return run


def test_latency_percentiles_take_every_request_due_in_the_window():
    run = _run()
    lat = [i + 1.0 for i in range(20) if i != 7]
    assert reader("latency_p50_ms").read(run) == pytest.approx(
        stats.percentile(lat, 50))
    assert reader("latency_p95_ms").read(run) == pytest.approx(
        stats.percentile(lat, 95))


def test_requests_per_s_counts_answers_inside_the_window():
    run = _run()
    # 19 sound answers inside [10, 20], plus the early one done at 10.5
    assert reader("requests_per_s").read(run) == pytest.approx(20 / 10)


def test_hit_rate_counts_later_turns_only():
    run = _run()
    later = [i for i in range(20) if i != 7 and i % 3 >= 1]
    want = sum(i % 2 == 0 for i in later) / len(later)
    assert reader("hit_rate").read(run) == pytest.approx(want)
    assert reader("setup_s").read(run) == 3.5


class _E:
    def __init__(self, name, dev, a, b):
        self.n, self.d, self.a, self.b = name, dev, a, b

    def name(self):
        return self.n

    def device_type(self):
        return "DeviceType." + self.d

    def start_ns(self):
        return self.a

    def end_ns(self):
        return self.b


def _timeline():
    ms = 1_000_000
    return [_E("cb.window", "CPU", 0, 100 * ms),
            _E("cb.encoder#0", "CPU", 0, 40 * ms),
            _E("cb.knn#0", "CPU", 50 * ms, 90 * ms),
            _E("cb.encoder#0", "CUDA", 5 * ms, 35 * ms),
            _E("cb.knn#0", "CUDA", 55 * ms, 85 * ms),
            _E("gemm", "CUDA", 5 * ms, 15 * ms),
            _E("gemm", "CUDA", 20 * ms, 35 * ms),
            _E("score", "CUDA", 55 * ms, 85 * ms),
            _E("memcpy", "CUDA", 95 * ms, 120 * ms)]


def test_idle_share_busy_and_charges_from_a_synthetic_timeline():
    r = trace.read_events(_timeline())
    assert r.window_s == pytest.approx(0.1)
    # busy: 10 + 15 + 30 + 5 (the copy clipped at the window) ms
    assert r.busy_s == pytest.approx(0.060)
    assert r.device_by_range == pytest.approx({"cb.encoder#0": 0.025,
                                               "cb.knn#0": 0.030})
    assert r.device_ops == pytest.approx({"gemm": 0.025, "score": 0.030,
                                          "memcpy": 0.005})
    # idle 40 ms: 5 + 5 inside the encoder's range, 15 between, 10 in knn
    assert sum(r.idle_by_host.values()) == pytest.approx(0.040)
    assert r.idle_by_host["cb.encoder"] == pytest.approx(0.010)
    assert r.idle_by_host["cb.knn"] == pytest.approx(0.010)
    run = RunRecord(t_open=0, t_close=1, trace=r)
    assert reader("device.idle_share").read(run) == pytest.approx(40.0)


def test_roofline_and_mfu_readers_over_charged_calls():
    r = trace.read_events(_timeline())
    flops, nbytes = costs.knn_search(64, 1000, 769, 800, 10)
    run = RunRecord(t_open=0, t_close=1, trace=r, calls={
        "knn": [Call("cb.knn#0", 0, 1, flops, nbytes),
                Call("cb.knn#9", 0, 1, 1e15, 1e15)],     # not traced
        "encoder": [Call("cb.encoder#0", 0, 1, 2e12, 0)]})
    least = hardware.least_time(flops, nbytes)
    assert reader("knn_roofline").read(run) == pytest.approx(
        100 * least / 0.030)
    assert reader("encoder.mfu").read(run) == pytest.approx(
        100 * 2e12 / hardware.TF32_FLOPS / 0.025)
    assert reader("knn_roofline").read(RunRecord(0, 1)) is None


def test_knn_search_counts_inputs_and_outputs_once():
    flops, nbytes = costs.knn_search(64, 8_841_823, 769, 800, 1000)
    assert flops == 2 * 64 * 8_841_823 * 769
    assert nbytes == 8_841_823 * 800 * 4 + 64 * 800 * 4 + 64 * 1000 * 8
    # the H100 bound of a B = 64 search: the corpus read at 3.35 TB/s
    assert hardware.least_time(flops, nbytes) == pytest.approx(
        nbytes / 3.35e12)


def test_encoder_flops_by_hand():
    enc = {"n_layers": 2, "d_model": 8, "n_heads": 2, "n_kv_heads": 1,
           "d_head": 4, "d_ff": 16, "out_dim": 8}
    layer = 8 * 8 + 2 * 8 * 4 + 8 * 8 + 8 * 32 + 16 * 8
    n = 5
    attn = 2 * 2 * 8 * n * (n + 1) / 2
    want = 2 * (2 * layer * n + attn) + 2 * 8 * 8
    assert costs.encoder_flops(enc, [n]) == pytest.approx(want)
    assert costs.encoder_flops(enc, [n, n]) == pytest.approx(2 * want)


def test_seqrec_flops_by_hand():
    d, blocks, mult, vocab = 4, 2, 4, 100
    per_tok = 2 * (4 * d * d + 2 * d * mult * d)
    n = 3
    want = blocks * (per_tok * n + 2 * 2 * d * n * (n + 1) / 2) \
        + 2 * vocab * d
    assert costs.seqrec_flops(d, blocks, mult, [n], vocab) == \
        pytest.approx(want)


def test_step_mfu_is_flops_over_service_time_at_the_tf32_peak():
    run = RunRecord(t_open=0, t_close=1, model_flops=4.95e12, service_s=0.5)
    assert reader("step_mfu").read(run) == pytest.approx(2.0)
    assert math.isclose(hardware.TF32_FLOPS, 495e12)
