"""A later change adds a configuration, a cell and a per-layer metric by
adding files and manifest entries only.  Here they live only in the
test's temporary folder: a stub program behind a driver of its own, a
traffic mix, a cell file and a metric reader; the harness finds each by
name, with the benchmark's folder behind it for everything else."""

import json
import time

from chipbench import run as harness

STUB_DRIVER = '''
"""A stub program: requests answered by a function on the host."""
import time

from chipbench.record import Call, Request, RunRecord


def setup(ctx):
    return {"scale": ctx.cfg["sizes"]["scale"], "calls": []}


def serve(system, ctx):
    t0 = time.perf_counter()
    run = RunRecord(t_open=t0 + ctx.traffic["ramp_s"],
                    t_close=t0 + ctx.traffic["ramp_s"] + ctx.seconds)
    i = 0
    while time.perf_counter() <= run.t_close:
        due = time.perf_counter()
        time.sleep(ctx.traffic["service_s"])
        req = Request(due=due, done=time.perf_counter(), ok=True,
                      measured=due >= run.t_open, conv=i,
                      answer=i * system["scale"])
        run.requests.append(req)
        i += 1
    run.service_s = run.window_s
    run.calls = {"stub": [Call("cb.stub#0", t0, t0, 1.0, 1.0)]}
    run.notes["served"] = i
    return run


def release(system):
    pass


def check(system, run, ctx):
    wrong = sum(r.answer != r.conv * 2 for r in run.requests if r.ok)
    return {"wrong": float(wrong)}
'''

STUB_METRIC = '''
"""Requests the stub served in the window (a per-layer count)."""


def read(run):
    return float(sum(1 for r in run.requests if run.in_window(r.done)))
'''


def test_a_cell_a_config_and_a_metric_from_new_files_only(tmp_path):
    man = harness.load_json(harness.ROOT / "BENCHMARK.json")
    man["configs"].append({"name": "stub", "source": "https://example.org",
                           "file": "chipbench/configs/stub.json",
                           "reduced": [], "why": "a stub"})
    man["workloads"].append({"name": "stub.echo", "config": "stub",
                             "traffic": "echo", "chips": 1,
                             "why": "a stub cell"})
    man["per_layer"].append({"name": "stub_served", "unit": "requests",
                             "better": "higher", "source": "program_counter",
                             "layer": "stub", "moves": "latency_p50_ms",
                             "workloads": ["stub.echo"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    new = tmp_path / "chipbench"
    for sub, name, text in (
            ("configs", "stub.json", json.dumps(
                {"driver": "stub", "sizes": {"scale": 2},
                 "limits": {"wrong": 0}})),
            ("traffic", "echo.json", json.dumps(
                {"ramp_s": 0.05, "service_s": 0.002})),
            ("workloads", "stub.echo.json", json.dumps({"service_s": 0.003})),
            ("drivers", "stub.py", STUB_DRIVER),
            ("metrics", "stub_served.py", STUB_METRIC)):
        (new / sub).mkdir(parents=True, exist_ok=True)
        (new / sub / name).write_text(text)
    manifest = harness.load_json(tmp_path / "BENCHMARK.json")
    cell = harness.Cell(manifest, "stub.echo", root=tmp_path,
                        dirs=(new, harness.HERE))
    assert cell.traffic["service_s"] == 0.003       # the cell's own file
    plain = harness.run_cell(cell, 5, 0.3, False, device="cpu",
                             t_process=time.perf_counter())
    traced = harness.run_cell(cell, 5, 0.3, True, device="cpu",
                              t_process=time.perf_counter())
    assert plain["correct"] and plain["attempted"] > 10
    # the existing readers, found in the benchmark's own folder
    assert set(plain["metrics"]) == {"latency_p50_ms", "latency_p95_ms",
                                     "requests_per_s", "setup_s"}
    assert plain["metrics"]["latency_p50_ms"]["value"] >= 3.0
    # the new reader, found in the new folder, reported where it is listed
    assert traced["metrics"]["stub_served"]["value"] > 10
    assert list(traced)[-1] == "checks"
    assert traced["checks"] == {"wrong": {"value": 0.0, "limit": 0.0}}
