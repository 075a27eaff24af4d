"""The command as `BENCHMARK.json` gives it: without the cards a cell asks for,
or in a folder holding only the manifest and the benchmark, it exits with
another code than 0 and prints no result."""

import shutil
import subprocess
import sys

import pytest

from chipbench import run as harness

ARGS = ["-m", "chipbench.run", "--workload", "sasrec.serve", "--seed",
        "4294967311", "--seconds", "1", "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "HOME": str(cwd)})


def _no_result(out: str) -> bool:
    last = out.strip().splitlines()[-1] if out.strip() else ""
    return '"correct"' not in last


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would proceed")
    got = _run(harness.ROOT)
    assert got.returncode != 0 and _no_result(got.stdout)


def test_only_the_benchmark_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    got = _run(tmp_path)
    assert got.returncode != 0 and _no_result(got.stdout)
