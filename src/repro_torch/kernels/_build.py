"""Build the port's CUDA sources with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on first use into its own shared library
with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -DREPRO_FUSED_MAX_TILE=4096 ... \\
         -o build/repro_torch/lib<name>-<hash>.so <name>.cu

keyed by a hash of the source (and the shared header) plus the flags, so an
edited kernel rebuilds and an unchanged one is reused.  ``build_all`` starts
one ``nvcc`` per source at once and waits for all of them.  A missing
``nvcc`` or a failed build raises; nothing falls back to the plain path.

Every C entry point takes device pointers and the CUDA stream as
``c_void_p`` (so no 64-bit value is cut to an int), integers as ``c_int``
or ``c_longlong``, floats as ``c_float``, launches on the given stream and
returns ``cudaGetLastError()``; ``check`` raises on a non-zero code.

Every number that the wrappers and ``csrc/`` must agree on is defined
here once, in ``DEFINES``, and reaches ``nvcc`` as ``-DREPRO_<NAME>``; each
source that uses one refuses to build without it.  ``library_path`` hashes
the flags, so a changed value rebuilds.

The block select of ``csrc/select.cuh`` (the cache wave's query) keeps its
(key, position) survivors in shared memory up to ``SMEM_PAIRS`` pairs and
in a global scratch buffer beyond, as the kNN select does its candidates.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["SOURCES", "CSRC", "BUILD_DIR", "NVCC_FLAGS", "DEFINES", "STORE",
           "PAYLOADS", "SMEM_PAIRS", "FUSED_MAX_TILE", "SCORE_GEMV_MAX_B",
           "QUERY_TILE", "FEAT", "SELECT_WS", "MAX_ROWS",
           "WAVE_BLOCKS_PER_SM", "WAVE_CHUNK_ALIGN", "nvcc_path",
           "library_path", "build_all", "function", "check", "stream_of"]

SOURCES = ("cache_probe", "knn", "cache_wave", "embedding_bag")
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

# storage codes of the C entry points (csrc/common.cuh ``repro::Store``)
STORE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
         torch.float16: 3}
# the payloads the kNN, probe and cache-wave kernels read
PAYLOADS = (torch.float32, torch.bfloat16, torch.int8)

# survivors of a block select held in shared memory (8 B each: 128 KB of
# the 227 KB a Hopper block may opt into)
SMEM_PAIRS = 16384

# the widest tile of the two-stage scan that the fused tile kernel takes (a
# thread-block cluster of 16 blocks of 256 documents)
FUSED_MAX_TILE = 4096
# the largest B that takes the kNN score's single-query path (a GEMV), and
# the widest query block of that path (measured crossover: PERF.md)
SCORE_GEMV_MAX_B = 8
# queries per tile of the kNN score GEMM; the search's chunks and the plain
# scores' matrix products come in whole tiles
QUERY_TILE = 64
# the score GEMM's features per ring stage: corpus and cache widths are
# multiples of it (core/layout.py pads to it)
FEAT = 32
# int32 words of the kNN select's workspace row: the histograms of its two
# 12-bit digits, 16 words of counters and pass state, the first digit's 256
# bins
SELECT_WS = 2 * 4096 + 16 + 256
# rows of a select, tile or wave grid (CUDA's gridDim.y)
MAX_ROWS = 65535
# the cache-wave kernel: resident blocks per SM (its __launch_bounds__),
# and its warps a block, the multiple of a block's slot chunk
WAVE_BLOCKS_PER_SM = 2
WAVE_CHUNK_ALIGN = 16

DEFINES = {"FUSED_MAX_TILE": FUSED_MAX_TILE,
           "SCORE_GEMV_MAX_B": SCORE_GEMV_MAX_B, "QUERY_TILE": QUERY_TILE,
           "FEAT": FEAT, "SELECT_WS": SELECT_WS, "MAX_ROWS": MAX_ROWS,
           "WAVE_BLOCKS_PER_SM": WAVE_BLOCKS_PER_SM,
           "WAVE_CHUNK_ALIGN": WAVE_CHUNK_ALIGN,
           **{"STORE_" + str(dt).removeprefix("torch.").upper(): code
              for dt, code in STORE.items()}}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              *(f"-DREPRO_{name}={value}" for name, value in DEFINES.items()))

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCS: dict[tuple, object] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def library_path(name: str) -> Path:
    """Content-keyed path of the shared library built from ``name``.cu."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES, verbose: bool = False) -> str:
    """Compile every missing library of ``names``, one ``nvcc`` per source,
    all started together, and return the compilers' output.  ``verbose``
    rebuilds with ``-Xptxas -v`` (registers, shared memory, spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in names:
        out = library_path(n)
        if out.exists() and not verbose:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    log, failed = [], []
    for n, (p, tmp, out) in procs.items():
        text, _ = p.communicate()
        log.append(f"== nvcc {n}.cu (exit {p.returncode})\n{text}")
        if p.returncode != 0:
            failed.append(n)
            continue
        os.replace(tmp, out)
    text = "\n".join(log)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{text}")
    return text


def _library(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        path = library_path(name)
        if not path.exists():
            build_all((name,))
        _LIBS[name] = ctypes.CDLL(str(path))
    return _LIBS[name]


def function(lib: str, fn: str, argtypes) -> object:
    """The C entry point ``fn`` of ``lib`` with its ``argtypes`` declared."""
    key = (lib, fn)
    with _LOCK:
        if key not in _FUNCS:
            f = getattr(_library(lib), fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
            _FUNCS[key] = f
        return _FUNCS[key]


def check(code: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer value."""
    return torch.cuda.current_stream(t.device).cuda_stream

