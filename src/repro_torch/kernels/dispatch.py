"""Device resolution and per-kernel counters for the port's kernel layer.

The JAX package dispatches across three tiers (``ref`` / ``interpret`` /
``compiled``) with an environment override.  The port has no tiers and no
override: a kernel wrapper follows the device of the tensors it is given.

  * a CUDA tensor launches the hand-written kernel, or raises;
  * a CPU tensor takes the plain PyTorch version beside the kernel.

``resolve_device(None)`` is ``cuda`` and raises when no card is present —
only an explicit ``device="cpu"`` selects the plain path.

Every kernel wrapper owns a ``KernelCounter`` with two plain integers:
``calls`` (wrapper entries on any device) and ``launches`` (CUDA launches).
Router threads call ``DeviceShard`` concurrently, so both are updated under
a lock.  ``counters()`` lists them by name for tests and ``chip_smoke.py``.
"""

from __future__ import annotations

import threading

import torch

__all__ = ["resolve_device", "is_kernel", "KernelCounter", "counter",
           "counters", "reset_counters"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; raise when it is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path")
    return dev


def is_kernel(t: torch.Tensor) -> bool:
    """True when ``t`` lives on the card, i.e. the kernel must launch."""
    return t.is_cuda


class KernelCounter:
    """``calls`` counts wrapper entries, ``launches`` CUDA launches."""

    def __init__(self, name: str):
        self.name = name
        self.calls = 0
        self.launches = 0
        self._lock = threading.Lock()

    def call(self) -> None:
        with self._lock:
            self.calls += 1

    def launch(self) -> None:
        with self._lock:
            self.launches += 1

    def reset(self) -> None:
        with self._lock:
            self.calls = 0
            self.launches = 0


_COUNTERS: dict[str, KernelCounter] = {}
_REGISTRY_LOCK = threading.Lock()


def counter(name: str) -> KernelCounter:
    """The named counter, created on first use."""
    with _REGISTRY_LOCK:
        if name not in _COUNTERS:
            _COUNTERS[name] = KernelCounter(name)
        return _COUNTERS[name]


def counters() -> dict[str, KernelCounter]:
    with _REGISTRY_LOCK:
        return dict(_COUNTERS)


def reset_counters() -> None:
    for c in counters().values():
        c.reset()
