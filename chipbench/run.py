"""Run one cell of ``BENCHMARK.json`` and print its result.

    python -m chipbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout (one process on one card).  Set-up makes the
cell's inputs from the seed, builds the program and warms the shapes the
cell's traffic uses; the load starts, the window opens and is measured
for ``--seconds``; every request due in it is answered (or given up a
minute past the close); the program's state is freed and its outputs are
held against ``chipbench.reference``.  The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics
read from a profiler trace of part of the window), ``device``,
``breakdown`` (traced runs) and last ``checks``: each compared number
with its limit, which also close standard error.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
JAX_NAMES = ("jax", "jaxlib", "flax", "repro")
INF = 1e300          # stands for an infinite reading (JSON has no inf)


def log(msg: str) -> None:
    print(msg, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import a file by path (metric readers and drivers are found by
    the names in ``BENCHMARK.json``)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell of the manifest and the files it names."""

    def __init__(self, manifest: dict, name: str, root: Path = ROOT,
                 dirs: tuple = (HERE,)):
        work = {w["name"]: w for w in manifest["workloads"]}
        if name not in work:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                             f"(have {sorted(work)})")
        self.manifest, self.name, self.entry = manifest, name, work[name]
        self.dirs = tuple(Path(d) for d in dirs)
        conf = {c["name"]: c for c in manifest["configs"]}[
            self.entry["config"]]
        self.cfg = load_json(root / conf["file"])
        self.traffic = load_json(self.find("traffic",
                                           f"{self.entry['traffic']}.json"))
        own = self.find("workloads", f"{name}.json", required=False)
        if own is not None:
            self.traffic.update(load_json(own))

    def find(self, sub: str, filename: str, required: bool = True):
        """``<dir>/<sub>/<filename>`` in the first of ``dirs`` that has
        it."""
        for d in self.dirs:
            if (d / sub / filename).exists():
                return d / sub / filename
        if required:
            raise FileNotFoundError(f"{sub}/{filename} in {self.dirs}")
        return None

    def metrics(self, traced: bool) -> list:
        kind = "per_layer" if traced else "end_to_end"
        return [m for m in self.manifest[kind]
                if self.name in m.get("workloads", [self.name])]

    def reader(self, metric: str):
        return load_module(self.find("metrics", f"{metric}.py"),
                           f"chipbench_metric_{metric.replace('.', '_')}")

    def driver(self):
        return load_module(self.find("drivers", f"{self.cfg['driver']}.py"),
                           f"chipbench_driver_{self.cfg['driver']}")


def jax_loaded() -> list:
    """Modules of JAX or the JAX package in this process (by whole
    top-level name)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(JAX_NAMES))


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


class CollectorPasses:
    """Passes of Python's cyclic collector (a ``gc.callbacks`` entry):
    each holds up every thread of the process, the program's too."""

    def __init__(self):
        self.passes: list = []        # (generation, start, end)
        self._t = None

    def __call__(self, phase: str, info: dict) -> None:
        now = time.perf_counter()
        if phase == "start":
            self._t = now
        elif self._t is not None:
            self.passes.append((info["generation"], self._t, now))
            self._t = None

    def notes(self, t_open: float, t_close: float) -> dict:
        """Passes that started inside the window: how many, and the
        seconds the full (generation 2) ones took."""
        inside = [p for p in self.passes if t_open <= p[1] <= t_close]
        full = [e - s for g, s, e in inside if g == 2]
        return {"gc_passes": len(inside), "gc_full_passes": len(full),
                "gc_full_ms": 1e3 * sum(full),
                "gc_all_ms": 1e3 * sum(e - s for _, s, e in inside)}


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t_process: float = T_PROCESS) -> dict:
    """Set up, serve, measure and check one cell; returns the result
    object (without printing it)."""
    import torch

    from chipbench import trace
    from chipbench.drivers.common import Ctx

    torch.set_num_threads(4)
    tracer = trace.Tracer(traced)
    ctx = Ctx(cfg=cell.cfg, traffic=cell.traffic, seed=seed,
              seconds=seconds, device=device, tracer=tracer, log=log)
    driver = cell.driver()
    if device != "cpu":
        from repro_torch.kernels import _build
        t0 = time.perf_counter()
        _build.build_all()
        log(f"[setup] kernels built or found in "
            f"{time.perf_counter() - t0:.2f} s")
    system = driver.setup(ctx)
    tracer.warm()
    gc.collect()          # the window starts with no collection owed
    passes = CollectorPasses()
    gc.callbacks.append(passes)
    try:
        run = driver.serve(system, ctx)
    finally:
        gc.callbacks.remove(passes)
    run.setup_s = run.t_open - t_process
    run.notes.update(passes.notes(run.t_open, run.t_close))
    gpu = device != "cpu"
    peak = torch.cuda.max_memory_allocated() if gpu else 0
    found = jax_loaded()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: "
                         f"{found}")
    metrics = {}
    for m in cell.metrics(traced):
        value = cell.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    measured = run.measured()
    failed = sum(1 for r in measured if not r.ok)
    log("[notes] " + json.dumps(run.notes, default=float))
    driver.release(system)
    try:
        numbers = driver.check(system, run, ctx)
    except Exception:                              # noqa: BLE001
        traceback.print_exc()
        numbers = {}
    limits = cell.cfg["limits"]
    checks = {n: {"value": min(float(numbers.get(n, INF)), INF),
                  "limit": float(limits[n])} for n in limits}
    correct = (bool(measured) and failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values()))
    dev = {"platform": "gpu" if gpu else "cpu",
           "kind": torch.cuda.get_device_name(0) if gpu else "cpu",
           "count": int(cell.entry["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": len(measured), "failed": failed,
           "metrics": metrics, "device": dev}
    if traced and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = {
            "device_ops": trace.top(run.trace.device_ops),
            "idle_gaps": trace.top(run.trace.idle_by_host)}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest = load_json(ROOT / "BENCHMARK.json")
    cell = Cell(manifest, args.workload)
    cache_dirs(ROOT)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell.entry["chips"]):
        print(f"needs {cell.entry['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from chipbench import hardware
    log(f"[card] {hardware.card_power_limit()}; torch {torch.__version__}")
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
