"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program.  Module names are compared by
their whole top-level name (``repro_torch`` is not ``repro``), in a fresh
interpreter so that nothing the test process loaded counts."""

import json
import subprocess
import sys

import pytest

from chipbench import run as harness

JAX_NAMES = {"jax", "jaxlib", "flax", "repro"}

IMPORT_ALL = r"""
import importlib, importlib.util, json, pathlib, sys
root = pathlib.Path(sys.argv[1])
sys.path[:0] = [str(root), str(root / "src")]
only = sys.argv[2]
for path in sorted((root / "chipbench").rglob("*.py")):
    rel = path.relative_to(root).with_suffix("")
    if "tests" in rel.parts or not str(rel).startswith(only):
        continue
    if rel.parent.name == "metrics":
        name = "m_" + rel.name.replace(".", "_")
        spec = importlib.util.spec_from_file_location(name, path)
        sys.modules[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[name])
    else:
        importlib.import_module(".".join(rel.parts))
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""


def _top_names(only: str) -> set:
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL,
                          str(harness.ROOT), only],
                         capture_output=True, text=True, check=True,
                         timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_no_module_of_the_benchmark_loads_jax_or_the_jax_package():
    names = _top_names("chipbench")
    assert not names & JAX_NAMES, names & JAX_NAMES


def test_the_reference_reaches_nothing_of_the_program():
    names = _top_names("chipbench/reference")
    assert "repro_torch" not in names
    assert not names & JAX_NAMES


@pytest.mark.parametrize("name,loaded", [
    ("repro_torch.core", False), ("repro.core", True), ("jax.numpy", True),
    ("jaxlib", True), ("flax", True), ("reprox", False)])
def test_whole_top_level_names_are_compared(monkeypatch, name, loaded):
    monkeypatch.setitem(sys.modules, name, object())
    assert (name.split(".")[0] in harness.jax_loaded()) == loaded
