"""What one of the program's spans costs the host, with the profiler off
and on.

    python -m chipbench.span_cost [--n 200000]

times ``n`` spans of the program's span log back to back (a plain span,
and a sync span around nothing), first with no profiler running, then
inside the traced runs' profiler (``chipbench.trace.Tracer``), and prints
one JSON line of nanoseconds per span and the machine it ran on.  A
wave's cost is this times its spans (``program_spans``' count from a
traced run).
"""

from __future__ import annotations

import json
import sys
import time


def per_span_ns(kind, n: int) -> float:
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with kind:
            pass
    return (time.perf_counter_ns() - t0) / n


def main(argv=None) -> int:
    import argparse

    from chipbench import hardware, run as harness, trace

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=200_000)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(harness.ROOT / "src"))
    import torch
    from repro_torch.serve.telemetry import SPANS, sync_site

    plain = SPANS.kind("serve.cost_probe")
    sync = sync_site("cost_probe")
    out = {"card": hardware.card_power_limit() if torch.cuda.is_available()
           else "cpu", "n": args.n}
    for kind, name in ((plain, "span"), (sync, "sync_span")):
        per_span_ns(kind, 1000)
        out[f"{name}_off_ns"] = per_span_ns(kind, args.n)
    tracer = trace.Tracer(True)
    tracer.warm()
    with tracer.profile():
        for kind, name in ((plain, "span"), (sync, "sync_span")):
            out[f"{name}_on_ns"] = per_span_ns(kind, args.n // 10)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
