"""Find the knee of an open-loop cell: set it up once, then measure a
window at each offered rate in turn.

    python -m chipbench.sweep --workload cast19-star.sessions --seed 7 \\
        --seconds 8 --rates 40,60,80

One line per rate: the offered and the answered turns a second, latency
p50 and p95, the peak of open and of waiting conversations, and how late
the generator ran.  The knee is the highest rate whose answered rate
keeps up with the offered one while the latency stays flat; a cell below
it records its rate in ``workloads/<cell>.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from chipbench import run as harness
from chipbench import stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True,
                    help="conversations a second, comma-separated")
    args = ap.parse_args(argv)
    t_process = time.perf_counter()
    cell = harness.Cell(harness.load_json(harness.ROOT / "BENCHMARK.json"),
                        args.workload)
    harness.cache_dirs(harness.ROOT)
    sys.path.insert(0, str(harness.ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    from chipbench.drivers.common import Ctx
    from chipbench.trace import Tracer
    _build.build_all()
    driver = cell.driver()
    ctx = Ctx(cfg=cell.cfg, traffic=dict(cell.traffic), seed=args.seed,
              seconds=args.seconds, device="cuda", tracer=Tracer(False),
              log=harness.log)
    system = driver.setup(ctx)
    harness.log(f"[sweep] set up in {time.perf_counter() - t_process:.1f} s")
    for rate in (float(r) for r in args.rates.split(",")):
        ctx.traffic["conversations_per_s"] = rate
        driver.fresh_front_door(system)
        run = driver.serve(system, ctx)
        lat = [r.latency_s * 1e3 for r in run.completed()]
        done = sum(1 for r in run.requests if r.ok and run.in_window(r.done))
        later = [r for r in run.completed() if r.turn >= 1]
        harness.log("[sweep] " + json.dumps({
            "conversations_per_s": rate,
            "offered_turns_per_s": rate * ctx.traffic["turns"],
            "answered_per_s": done / run.window_s,
            "p50_ms": stats.percentile(lat, 50),
            "p95_ms": stats.percentile(lat, 95),
            "hit_rate": (sum(r.hit for r in later) / len(later)
                         if later else None),
            "failed": sum(1 for r in run.measured() if not r.ok),
            "mean_wave": (sum(w["size"] for w in run.waves)
                          / max(len(run.waves), 1)),
            **run.notes}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
