"""Smoke-size copies of the configurations, for runs on the CPU: the same
files and code paths as the cells, at widths a test can hold."""

from __future__ import annotations

import json
from pathlib import Path

from chipbench import run as harness

SEED = 12_345_678_901        # seeds may run past 32 bits

# a cell whose files and code path the benchmark keeps, though the manifest
# leaves it out (its numbers follow the host's speed too closely for a
# bound); the smoke manifest carries it so that the path stays tested
ONE_SESSION = {"name": "cast19-star.one_session", "config": "cast19-star",
               "traffic": "one_session", "chips": 1,
               "why": "the paper's client, one conversation at a time"}


def smoke_root(tmp: Path) -> Path:
    """A root holding ``BENCHMARK.json`` and smoke-size configuration files
    under the names the manifest gives."""
    man = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for conf in man["configs"]:
        cfg = harness.load_json(harness.ROOT / conf["file"])
        if cfg["driver"] == "conversational":
            cfg["encoder"].update(n_layers=2, d_model=32, n_heads=4,
                                  n_kv_heads=4, d_head=8, d_ff=64,
                                  vocab_size=256, q_chunk=64, kv_chunk=64,
                                  out_dim=32)
            cfg["corpus"].update(n_docs=20_000, dim=32, stored_width=64,
                                 planted_per_centre=16, subspace_dim=4)
            cfg["scripts"].update(n_scripts=16, seq=32, prefix=8,
                                  suffix=[4, 20])
            cfg["cache"].update(k_c=50, capacity=800)
            cfg["engine"].update(n_sessions=8, max_wave=8)
        else:
            cfg["model"].update(vocab=5000, max_len=12, embed_dim=16,
                                stored_width=32)
        path = tmp / conf["file"]
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(cfg))
    if ONE_SESSION["name"] not in {w["name"] for w in man["workloads"]}:
        man["workloads"].append(ONE_SESSION)
    (tmp / "BENCHMARK.json").write_text(json.dumps(man))
    return tmp


SMOKE_TRAFFIC = {
    "cast19-star.sessions": {"conversations_per_s": 3.0, "sample": 4,
                             "ramp_s": 1.0},
    "cast19-star.cold": {"clients": 4, "sample": 8, "ramp_s": 0.5},
    "cast19-star.one_session": {"sample": 4, "ramp_s": 0.5},
    "sasrec.serve": {"batch": 16, "sample": 2, "sample_among": 4,
                     "ramp_s": 0.2},
}
SMOKE_SECONDS = {"cast19-star.sessions": 5.0, "cast19-star.cold": 2.0,
                 "cast19-star.one_session": 3.0, "sasrec.serve": 1.5}


def smoke_cell(root: Path, name: str, dirs=(harness.HERE,)) -> harness.Cell:
    man = harness.load_json(root / "BENCHMARK.json")
    cell = harness.Cell(man, name, root=root, dirs=dirs)
    cell.traffic.update(SMOKE_TRAFFIC.get(name, {}))
    return cell


def smoke_run(root: Path, name: str, traced: bool = False,
              seed: int = SEED, **traffic) -> dict:
    import time
    cell = smoke_cell(root, name)
    cell.traffic.update(traffic)
    return harness.run_cell(cell, seed, SMOKE_SECONDS[name], traced,
                            device="cpu", t_process=time.perf_counter())
