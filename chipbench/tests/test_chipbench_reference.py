"""The reference against the program at smoke sizes on the CPU, and each
cell's whole run (set-up, load, window, check) through the harness on the
CPU, with ``correct`` true."""

import pytest
import torch

from chipbench import inputs
from chipbench import run as harness
from chipbench.reference import eq1, full_f32
from chipbench.reference import encoder as ref_encoder
from chipbench.reference import seqrec as ref_seqrec
from chipbench.tests.smoke import SEED, smoke_root, smoke_run

CELLS = ["cast19-star.sessions", "sasrec.serve", "cast19-star.cold",
         "cast19-star.one_session"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smoke_root(tmp_path_factory.mktemp("smoke"))


def _cfg(root, name):
    return harness.load_json(root / "chipbench" / "configs" / f"{name}.json")


def test_encoder_matches_the_programs(root):
    from repro_torch.serve.engine import make_lm_query_encoder
    from chipbench.drivers.conversational import _transformer_config
    enc = _cfg(root, "cast19-star")["encoder"]
    w = inputs.encoder_weights(enc, SEED, "cpu")
    tok = torch.randint(0, enc["vocab_size"], (5, 32), generator=torch
                        .Generator().manual_seed(1), dtype=torch.int32)
    tok[torch.arange(32)[None, :] >= torch.tensor([32, 20, 9, 1, 31])[:, None]] = -1
    prog = make_lm_query_encoder(w["params"], _transformer_config(enc),
                                 w["proj"], device="cpu")(tok)
    with full_f32():
        ref = ref_encoder.encode(w, tok, enc)
    assert ref.shape == prog.shape == (5, enc["out_dim"] + 1)
    assert float((ref - prog).abs().max()) < 1e-5
    assert torch.allclose(torch.linalg.vector_norm(ref, dim=1),
                          torch.ones(5), atol=1e-6)


def test_eq1_matches_the_programs():
    from repro_torch.core import embedding
    x = torch.randn(50, 12) * torch.rand(50, 1)
    m = float(torch.linalg.vector_norm(x, dim=1).max())
    assert torch.allclose(eq1.documents(x, m),
                          embedding.transform_documents(x, m)[0], atol=1e-7)


def test_sasrec_matches_the_programs(root):
    from repro_torch.models import recsys
    from chipbench.drivers.seqrec import _load, model_config
    cfg = _cfg(root, "sasrec")
    w = inputs.seqrec_weights(cfg["model"], SEED, "cpu")
    model = recsys.SeqRec(model_config(cfg), device="cpu")
    with torch.no_grad():
        _load(model.params, w)
    tr = dict(harness.load_json(harness.HERE / "traffic" / "serve.json"),
              pool=1, batch=32)
    items = inputs.histories(tr, cfg["model"]["vocab"],
                             cfg["model"]["max_len"], SEED)[0]
    with full_f32():
        q = ref_seqrec.session_repr(w, torch.as_tensor(items), cfg["model"])
        s, i = ref_seqrec.topk(w, q, 10)
    got_s, got_i = model.retrieve(items, 10)
    assert float((model.session_repr(items) - q).abs().max()) < 1e-5
    assert float((got_s - s).abs().max()) < 1e-5
    assert (got_i.long() == i).float().mean() > 0.95      # ties may swap


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_runs_correct_on_the_cpu(root, cell):
    out = smoke_run(root, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert "setup_s" in out["metrics"] and "latency_p95_ms" in out["metrics"]
    assert out["device"]["platform"] == "cpu"
    assert list(out)[-1] == "checks"


def test_a_traced_run_reports_its_per_layer_metrics(root):
    out = smoke_run(root, "cast19-star.sessions", traced=True)
    assert out["correct"]
    assert {"queue_wait_ms.p95", "backend_ms.p50", "fill_ms.p50",
            "step_mfu"} <= set(out["metrics"])
    assert "breakdown" in out and "busy_s" in out["device"]
