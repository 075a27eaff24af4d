"""Build the port's CUDA sources with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on first use into its own shared library
with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -DREPRO_FUSED_MAX_TILE=4096 \\
         -o build/repro_torch/lib<name>-<hash>.so <name>.cu

keyed by a hash of the source (and the shared header) plus the flags, so an
edited kernel rebuilds and an unchanged one is reused.  ``build_all`` starts
one ``nvcc`` per source at once and waits for all of them.  A missing
``nvcc`` or a failed build raises; nothing falls back to the plain path.

Every C entry point takes device pointers and the CUDA stream as
``c_void_p`` (so no 64-bit value is cut to an int), integers as ``c_int``
or ``c_longlong``, floats as ``c_float``, launches on the given stream and
returns ``cudaGetLastError()``; ``check`` raises on a non-zero code.

The two block selects of ``csrc/select.cuh`` that take any k (the
two-stage scan's kept tile select, the cache wave's query) keep their
(key, position) survivors in shared memory up to
``SMEM_PAIRS`` pairs and in a global scratch buffer beyond;
``pair_scratch`` makes that choice for both wrappers.  The kNN select sorts
its candidates in shared memory up to ``SMEM_PAIRS`` pairs too, and in its
own scratch beyond.
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

__all__ = ["SOURCES", "CSRC", "BUILD_DIR", "NVCC_FLAGS", "STORE",
           "SMEM_PAIRS", "FUSED_MAX_TILE", "nvcc_path", "library_path",
           "build_all", "function", "check", "stream_of", "pair_scratch"]

SOURCES = ("cache_probe", "knn", "cache_wave", "embedding_bag")
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

# storage codes of the C entry points (csrc/common.cuh ``repro::Store``)
STORE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# survivors of a block select held in shared memory (8 B each: 128 KB of
# the 227 KB a Hopper block may opt into)
SMEM_PAIRS = 16384

# the widest tile of the two-stage scan that the fused tile kernel takes (a
# thread-block cluster of 16 blocks of 256 documents); ``csrc/knn.cu`` gets
# it as ``REPRO_FUSED_MAX_TILE`` and ``kernels/knn/ops.py`` keeps the
# score + tile-select pair for wider tiles
FUSED_MAX_TILE = 4096
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              f"-DREPRO_FUSED_MAX_TILE={FUSED_MAX_TILE}")

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


def pair_scratch(rows: int, k: int, device):
    """(kp, keys, positions) for ``rows`` block selects of the top ``k``:
    kp is k rounded up to a power of two; the buffers are None when kp
    pairs fit in shared memory, else (rows, kp) int32 scratch."""
    if not 1 <= k <= 2 ** 30:
        raise ValueError(f"k={k} outside [1, 2**30]")
    kp = 1 << (k - 1).bit_length()
    if kp <= SMEM_PAIRS:
        return kp, None, None
    return kp, *(torch.empty((rows, kp), dtype=torch.int32, device=device)
                 for _ in range(2))
