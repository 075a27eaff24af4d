"""The control of ``correct``: the reference, put in the program's place
and computed one step below the stated precision (TF32 operands for the
configurations' float32 products), must come out as not correct.

    python -m chipbench.control --workload cast19-star.sessions \\
        --seeds 11,12,13

For each seed it makes the cell's inputs, answers as many requests as a
run's check compares (the same sample size, drawn the same way from the
seed) with ``chipbench.reference`` at TF32 in place of the program, holds
those answers against the reference at float32 with the cell's own
comparison, and prints each number beside the cell's limit.  The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

from chipbench import run as harness


def run_control(cell, seed: int, device: str) -> dict:
    """The cell's check numbers with the cell driver's ``control`` in the
    program's place."""
    from chipbench.drivers.common import Ctx
    from chipbench.trace import Tracer
    ctx = Ctx(cfg=cell.cfg, traffic=cell.traffic, seed=seed, seconds=0.0,
              device=device, tracer=Tracer(False), log=harness.log)
    return cell.driver().control(ctx)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = harness.Cell(harness.load_json(harness.ROOT / "BENCHMARK.json"),
                        args.workload)
    sys.path.insert(0, str(harness.ROOT / "src"))
    limits = cell.cfg["limits"]
    for seed in (int(s) for s in args.seeds.split(",")):
        got = run_control(cell, seed, args.device)
        fails = [n for n in limits if got.get(n, float("inf")) > limits[n]]
        harness.log("[control] " + json.dumps({
            "workload": args.workload, "seed": seed, "numbers": got,
            "limits": limits, "fails": fails}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
