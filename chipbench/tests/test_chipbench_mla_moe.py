"""The ``moonlight-16b-a3b.sessions`` cell at smoke size on the CPU.

The harness finds the cell's driver, mix override and metric readers by
name from a folder that holds only those files (the cell's own), with the
benchmark's folder behind it for the rest, as a later change adds a cell;
the run is correct, a traced run reads the new program-side metrics, and
the control (the reference's encoder at fp8 in the program's place)
fails a limit."""

import json
import shutil
import time

import numpy as np
import pytest
import torch

from chipbench import control
from chipbench import run as harness
from chipbench.drivers.conversational_mla_moe import answer_gap
from chipbench.reference.cache import TurnCheck

CELL = "moonlight-16b-a3b.sessions"
OWN = {"drivers": ["conversational_mla_moe.py"],
       "workloads": [f"{CELL}.json"],
       "metrics": ["experts.roofline.py", "moe_ms.p50.py",
                   "expert_load.max_over_mean.py"]}
SMOKE = dict(num_hidden_layers=3, hidden_size=64, num_attention_heads=4,
             num_key_value_heads=4, qk_nope_head_dim=8, qk_rope_head_dim=4,
             v_head_dim=8, kv_lora_rank=16, intermediate_size=96,
             moe_intermediate_size=24, n_routed_experts=8,
             num_experts_per_tok=3, vocab_size=512)
SEED = 12_345_678_901


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mla_moe")
    man = harness.load_json(harness.ROOT / "BENCHMARK.json")
    conf = {c["name"]: c for c in man["configs"]}["moonlight-16b-a3b"]
    cfg = harness.load_json(harness.ROOT / conf["file"])
    cfg.update(SMOKE)
    cfg["model"].update(dtype="float32", out_dim=32, q_chunk=64,
                        kv_chunk=64)
    cfg["corpus"].update(n_docs=20_000, dim=32, stored_width=64,
                         planted_per_centre=16, subspace_dim=4)
    cfg["scripts"].update(n_scripts=16, seq=32, prefix=8, suffix=[4, 20])
    cfg["cache"].update(k_c=50, capacity=800)
    cfg["engine"].update(n_sessions=8, max_wave=8)
    # f32 at smoke size: the program within f32 rounding of the reference
    cfg["limits"].update(psi_gap=1e-4, answer_gap=1e-4)
    (tmp / conf["file"]).parent.mkdir(parents=True)
    (tmp / conf["file"]).write_text(json.dumps(cfg))
    (tmp / "BENCHMARK.json").write_text(json.dumps(man))
    own = tmp / "chipbench"
    for sub, names in OWN.items():
        (own / sub).mkdir(parents=True, exist_ok=True)
        for name in names:
            shutil.copy(harness.HERE / sub / name, own / sub / name)
    c = harness.Cell(harness.load_json(tmp / "BENCHMARK.json"), CELL,
                     root=tmp, dirs=(own, harness.HERE))
    c.traffic.update(conversations_per_s=3.0, sample=4, ramp_s=1.0)
    return c, own


def test_the_cell_is_found_by_name_in_its_own_files(cell):
    c, own = cell
    assert c.find("drivers", "conversational_mla_moe.py").parent.parent \
        == own
    assert c.find("traffic", "sessions.json").parent.parent == harness.HERE
    assert c.traffic["conversations_per_s"] == 3.0
    names = {m["name"] for m in c.metrics(True)}
    assert names == {"experts.roofline", "moe_ms.p50",
                     "expert_load.max_over_mean"}
    for m in names:
        assert c.reader(m).read is not None


def test_a_run_is_correct_and_reads_the_moe_metrics(cell):
    c, _own = cell
    plain = harness.run_cell(c, SEED, 4.0, False, device="cpu",
                             t_process=time.perf_counter())
    assert plain["correct"] and plain["attempted"] > 20
    assert set(plain["metrics"]) == {"latency_p50_ms", "latency_p95_ms",
                                     "requests_per_s", "setup_s"}
    traced = harness.run_cell(c, SEED, 4.0, True, device="cpu",
                              t_process=time.perf_counter())
    assert traced["correct"]
    got = traced["metrics"]
    # no device activity on the CPU: the roofline share has nothing to read
    assert set(got) == {"moe_ms.p50", "expert_load.max_over_mean"}
    assert got["moe_ms.p50"]["value"] > 0
    assert got["expert_load.max_over_mean"]["value"] >= 1.0


def test_the_fp8_control_fails_a_limit(cell):
    c, _own = cell
    got = control.run_control(c, SEED, "cpu")
    limits = c.cfg["limits"]
    assert any(got[n] > limits[n] for n in limits), got


def test_an_answered_document_the_replay_lacks_is_scored():
    """``answer_gap``: the program's answer holds a document the replay's
    cache never fetched (the bf16 program's k_c-th documents differ from
    the reference's); it reads the gap by which the reference scores it
    below the replay's document of that rank, not +inf."""
    docs = torch.tensor([[1.0, 0.0], [0.9, 0.1], [0.8, 0.2], [0.7, 0.3]])
    row_of = {10: 0, 11: 1, 12: 2, 13: 3}
    psi = torch.tensor([[1.0, 0.0]])
    miss = [TurnCheck(hit=False, flip=False, borderline=False,
                      answer_gap=float("inf"))]
    topk = torch.tensor([[10, 11, 12]])
    # the replay holds 10, 11, 12; the program answers 10 and 13
    got = answer_gap(psi, miss, [np.array([10, 13])], topk, docs, row_of, 2)
    assert got == pytest.approx(0.9 - 0.7)
    assert answer_gap(psi, miss, [np.array([10, 11])], topk, docs, row_of,
                      2) == 0.0
    assert answer_gap(psi, miss, [np.array([10, 10])], topk, docs, row_of,
                      2) == float("inf")
