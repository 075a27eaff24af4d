"""The numbers the kernel wrappers share with ``csrc/``, and the next power
of two, each with one owner.

``kernels/_build.py`` defines every number that a wrapper and a CUDA source
must agree on and passes it to ``nvcc`` as ``-DREPRO_<NAME>``: each source
that uses one refuses to build without it (an ``#ifndef`` / ``#error``
guard) and holds no literal copy of it, and the wrappers read the
``_build`` names.  ``core.layout.next_pow2`` serves every site that rounds
up to a power of two, each at the values it had before.
"""

import re
import types

import pytest
import torch

from repro_torch.core import layout
from repro_torch.kernels import _build
from repro_torch.kernels.cache_wave import ops as wave_ops
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.kernels.knn import ops as knn_ops
from repro_torch.serve import engine, scheduler, session, telemetry

SOURCES = sorted(_build.CSRC.glob("*.cu")) + sorted(_build.CSRC.glob("*.cuh"))
WRAPPERS = sorted(p for p in (_build.CSRC.parent / "kernels").rglob("*.py")
                  if p.name != "_build.py") + [_build.CSRC.parent / "core"
                                               / "layout.py"]
# the literal copies the numbers had in csrc/ before they had one owner
COPIES = {
    "FUSED_MAX_TILE": r"\bFUSED_MAX_TILE\s*=\s*\d+;",
    "SCORE_GEMV_MAX_B": r"\bGEMV_MAX_B\s*=\s*\d+;",
    "QUERY_TILE": r"\bGM\s*=\s*\d+;",
    "FEAT": r"\bGK\s*=\s*\d+;|\bdp\s*%\s*\d",
    "SELECT_WS": r"\bWS_ROW\s*=\s*\d+;",
    "MAX_ROWS": r"\b65535\b",
    "WAVE_BLOCKS_PER_SM": r"__launch_bounds__\(THREADS,\s*\d",
    "WAVE_CHUNK_ALIGN": r"\b(THREADS|WARPS)\s*=\s*\d+;",
}
STORE_COPY = r"\bk(F32|BF16|I8|F16)\s*=\s*\d"


def _code(path) -> str:
    """A source without its comments and ``static_assert`` lines (which
    may name a hardware limit)."""
    text = re.sub(r"//[^\n]*", "", path.read_text())
    return "\n".join(line for line in text.splitlines()
                     if "static_assert" not in line)


def _guarded(text: str) -> set:
    """Names of the ``REPRO_*`` macros an ``#ifndef`` line guards with an
    ``#error`` on the next line."""
    lines = text.splitlines()
    return {m.group(1) for a, b in zip(lines, lines[1:])
            if (m := re.match(r"#ifndef REPRO_(\w+)$", a.strip()))
            and b.strip().startswith("#error")}


def _value(name: str) -> int:
    if name.startswith("STORE_"):
        dtype = getattr(torch, name.removeprefix("STORE_").lower())
        return _build.STORE[dtype]
    return getattr(_build, name)


@pytest.mark.parametrize("name", sorted(_build.DEFINES))
def test_each_shared_number_reaches_nvcc_from_its_owner(name):
    """The flag carries the ``_build`` value; some source uses the macro;
    every source that uses it guards it; none holds a literal copy."""
    assert f"-DREPRO_{name}={_value(name)}" in _build.NVCC_FLAGS
    users = [p for p in SOURCES if re.search(rf"\bREPRO_{name}\b", _code(p))]
    assert users, f"no source reads REPRO_{name}"
    for p in users:
        assert name in _guarded(p.read_text()), f"{p.name}: REPRO_{name} unguarded"
    copy = STORE_COPY if name.startswith("STORE_") else COPIES[name]
    for p in SOURCES:
        assert not re.search(copy, _code(p)), f"{p.name} copies {name}"


def test_sources_read_no_macro_the_build_does_not_pass():
    for p in SOURCES:
        used = set(re.findall(r"\bREPRO_(\w+)", _code(p)))
        assert used <= set(_build.DEFINES), p.name


def test_select_workspace_row_is_laid_out_to_the_wrappers_size():
    assert "static_assert(WS_ROW == REPRO_SELECT_WS" in (
        _build.CSRC / "knn.cu").read_text()


def test_wrappers_read_the_build_names():
    assert knn_ops.SCORE_GEMV_MAX_B == _build.SCORE_GEMV_MAX_B
    assert knn_ops.QUERY_TILE == _build.QUERY_TILE
    assert knn_ops.MAX_ROWS == _build.MAX_ROWS
    assert knn_ops.FUSED_MAX_TILE == _build.FUSED_MAX_TILE
    assert wave_ops.BLOCKS_PER_SM == _build.WAVE_BLOCKS_PER_SM
    assert wave_ops.CHUNK_ALIGN == _build.WAVE_CHUNK_ALIGN
    assert layout.FEAT == _build.FEAT
    assert set(bag_ops.TABLE_DTYPES) | set(_build.PAYLOADS) == set(_build.STORE)
    own = re.compile(r"^\s*(SCORE_GEMV_MAX_B|FUSED_MAX_TILE|QUERY_TILE|"
                     r"QUERY_BLOCK|FEAT|SELECT_WS|MAX_ROWS|BLOCKS_PER_SM|"
                     r"CHUNK_ALIGN|STORE|TABLE_STORE)\s*=\s*[\d{(]", re.M)
    for p in WRAPPERS:
        text = p.read_text()
        assert not own.search(text), f"{p.name} defines a shared number"
        assert not re.search(r"\b65535\b", text), p.name


def _old_pow2(n: int, one_to_two: bool = False) -> int:
    return 1 << max(n - 1, 1 if one_to_two else 0).bit_length()


@pytest.mark.parametrize("n", [0, 1, 2, 3, 64, 65])
def test_next_pow2_sites_keep_their_values(n, monkeypatch):
    b = 1
    while b < n:
        b *= 2
    assert layout.next_pow2(n) == b == _old_pow2(n)
    assert session.BatchedEngine._bucket(
        types.SimpleNamespace(n_sessions=64), n) == min(b, 64)
    sched = types.SimpleNamespace(max_wave=48, min_wave=1, headroom=1.0,
                                  target_p99_s=None, wave_limit=48)
    for target in (n, n + 0.25, n - 0.5):
        w = 1
        while w < target and w < 48:
            w *= 2
        got = scheduler.ContinuousScheduler._target_limit(sched, target, 1.0)
        assert got == max(1, min(w, 48))
    tokens = torch.zeros((1, n), dtype=torch.long)
    assert engine.pad_length(tokens).shape[-1] == _old_pow2(n)
    assert telemetry.SpanLog(capacity=n).capacity == _old_pow2(n, True)
    assert layout.wave_tile(n) == min(512, max(8, _old_pow2(n, True)))
    assert knn_ops.autotune_knn(n, 128, 1, 1)[0] == min(
        4096, max(8, _old_pow2(n, True)))
    if n == 0:   # a select, a pair scratch and a corpus take at least one
        with pytest.raises(ValueError):
            wave_ops._pair_scratch(1, n, "cpu")
        return
    assert knn_ops._select_words(100, n)[0] == 2 << (n - 1).bit_length()
    assert wave_ops._pair_scratch(1, n, "cpu")[0] == _old_pow2(n)
    tiles = []
    tile_topk = knn_ops.knn_tile_topk

    def recorded(docs, doc_ids, queries, k_eff, tile_n, *args):
        tiles.append(tile_n)
        return tile_topk(docs, doc_ids, queries, k_eff, tile_n, *args)
    monkeypatch.setattr(knn_ops, "knn_tile_topk", recorded)
    docs = torch.ones((n, 32))
    knn_ops.knn_search(docs, torch.arange(n, dtype=torch.int32),
                       torch.ones((1, 32)), 1, tile_n=4096, two_stage=True)
    assert tiles == [min(4096, max(8, _old_pow2(n, True)))]
