"""The port stands alone: no JAX, no ``repro`` import, no silent fallback.

* every ``repro_torch`` module imports in a process where ``jax`` cannot
  be imported;
* no source line of ``src/repro_torch`` or ``chip_smoke.py`` imports
  ``repro`` or ``jax``;
* an entry point given ``device=None`` means the card and raises when there
  is none — only ``device="cpu"`` selects the plain path.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    return sorted(".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
                  .removesuffix(".__init__")
                  for p in PORT.rglob("*.py"))


def test_every_module_imports_without_jax():
    mods = _port_modules()
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'repro' or k.startswith('repro.')"
            " for k in sys.modules)\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=120)
    assert r.returncode == 0, r.stderr


def test_no_source_imports_repro_or_jax():
    pat = re.compile(r"^\s*(import\s+(repro|jax)\b(?!_)|from\s+(repro|jax)"
                     r"(\.|\s)(?!_))", re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in pat.finditer(f.read_text())]
    assert not bad, bad
    assert (ROOT / "chip_smoke.py").exists()


def test_dist_and_launch_modules_are_scanned_and_launcher_is_lean():
    """The distributed and launch layers and the op trace are among the
    modules scanned above, and the launcher a spawned rank imports first
    needs only torch and the standard library."""
    mods = _port_modules()
    for m in ("repro_torch.dist.api", "repro_torch.dist.sharding",
              "repro_torch.dist.retrieval", "repro_torch.launch.hostdevices",
              "repro_torch.launch.mesh", "repro_torch.launch.roofline",
              "repro_torch.launch.cells", "repro_torch.launch.dryrun",
              "repro_torch.launch.calibrate",
              "repro_torch.kernels.op_trace"):
        assert m in mods
    src = (PORT / "launch" / "hostdevices.py").read_text()
    tops = {m.group(1).split(".")[0] for m in re.finditer(
        r"^\s*(?:import|from)\s+([\w.]+)", src, re.M)}
    assert tops <= {"__future__", "datetime", "os", "queue", "tempfile",
                    "time", "traceback", "torch"}, tops


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_a_card(no_card):
    from repro_torch.core.cache import BatchedMetricCache, MetricCache
    from repro_torch.core.cache_ops import CacheConfig, init_batched_cache
    from repro_torch.core.cluster import assign_clusters
    from repro_torch.core.metric_index import MetricIndex
    from repro_torch.configs import star_encoder
    from repro_torch.core.shared import SharedTier
    from repro_torch.data.lm import LMBatchSpec, TokenStream
    from repro_torch.dist.retrieval import DeviceShard
    from repro_torch.kernels.dispatch import resolve_device
    from repro_torch.configs import sasrec
    from repro_torch.convert import kv_caches_from_numpy
    from repro_torch.models import egnn
    from repro_torch.models.recsys import SeqRec, candidate_index
    from repro_torch.models.transformer import (Transformer, init_kv_caches,
                                                init_params)
    from repro_torch.serve.engine import (ConversationalEngine,
                                          make_lm_query_encoder)
    from repro_torch.serve.session import BatchedEngine

    cfg = CacheConfig(capacity=8, dim=5)
    docs = np.eye(6, 5, dtype=np.float32)
    for make in (lambda: resolve_device(None),
                 lambda: init_batched_cache(cfg, 2),
                 lambda: BatchedMetricCache(cfg, 2),
                 lambda: MetricIndex(docs),
                 lambda: DeviceShard(docs, np.arange(6)),
                 lambda: BatchedEngine(None, docs, dim=5, n_sessions=2),
                 lambda: MetricCache(cfg),
                 lambda: SharedTier(dim=5),
                 lambda: assign_clusters(docs, docs[:2]),
                 lambda: ConversationalEngine(None, docs, dim=5),
                 lambda: Transformer(star_encoder.smoke_config()),
                 lambda: init_params(star_encoder.smoke_config()),
                 lambda: init_kv_caches(star_encoder.smoke_config(), 1, 4),
                 lambda: kv_caches_from_numpy([(np.zeros(2),)]),
                 lambda: make_lm_query_encoder(
                     init_params(star_encoder.smoke_config(), device="cpu"),
                     star_encoder.smoke_config(), np.eye(32, 8)),
                 lambda: TokenStream(LMBatchSpec(2, 8, 100)),
                 lambda: SeqRec(sasrec.smoke_config()),
                 lambda: candidate_index(torch.zeros(6, 32)),
                 lambda: egnn.init_params(egnn.EGNNConfig())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert resolve_device("cpu").type == "cpu"


def test_training_entry_points_follow_the_card(no_card, tmp_path):
    """The training script defaults to the card and raises without one;
    the step factories follow the parameters' device and a restore lands
    on the template's device, so a CPU state never asks for a card."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import star_encoder
    from repro_torch.train import encoder
    from repro_torch.train.optimizer import adafactor, adamw
    from repro_torch.train.step import make_lm_train_step

    with pytest.raises(RuntimeError, match="no CUDA device"):
        encoder.main(["--steps", "1", "--ckpt-dir", str(tmp_path / "a")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encoder.train(star_encoder.smoke_config(), 1, str(tmp_path / "b"))
    cfg = star_encoder.smoke_config()
    params = init_params_cpu(cfg)
    for opt in (adamw(), adafactor()):
        state = {"params": params, "opt": opt.init(params)}
        step = make_lm_train_step(cfg, opt, remat="none")
        state, m = step(state, {"tokens": np.zeros((2, 8), np.int32),
                                "labels": np.ones((2, 8), np.int32)})
        assert m["loss"].device.type == "cpu"
    mgr = CheckpointManager(str(tmp_path / "c"), interval=1)
    mgr.maybe_save(1, state)
    mgr.wait()
    out, step = mgr.restore_or(state)
    assert step == 1 and out["params"]["embed"].device.type == "cpu"


def test_training_script_runs_and_resumes_on_the_cpu(tmp_path, capsys):
    from repro_torch.train import encoder

    args = ["--device", "cpu", "--steps", "4", "--interval", "2",
            "--batch", "4", "--seq", "16", "--ckpt-dir", str(tmp_path)]
    assert encoder.main(args) == 0
    assert (tmp_path / "step_4").is_dir()
    assert encoder.main(args[:3] + ["6"] + args[4:]) == 0
    out = capsys.readouterr().out
    assert "resumed from checkpoint at step 4" in out and "step    5" in out


def init_params_cpu(cfg):
    from repro_torch.models.transformer import init_params
    return init_params(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_card_or_checkout(tmp_path, alone):
    """Without a visible card, or run from a directory holding nothing of
    the repo but the script, ``chip_smoke.py`` exits non-zero and prints
    no result."""
    script = ROOT / "chip_smoke.py"
    if alone:
        script = tmp_path / "chip_smoke.py"
        script.write_text((ROOT / "chip_smoke.py").read_text())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, cwd=script.parent, env=env, timeout=120)
    assert r.returncode != 0 and r.stdout == "", (r.returncode, r.stdout)
