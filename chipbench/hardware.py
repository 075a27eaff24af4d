"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the
700 W power limit): figures from the data sheet, not measurements.

f32 products with TF32 off are held against the TF32 tensor-core peak: a
split-TF32 product reaches f32 accuracy on the tensor cores, so the 67
TFLOP/s of the CUDA cores would not bound what an honest kernel can do.
"""

from __future__ import annotations

import shutil
import subprocess

TF32_FLOPS = 495e12          # TF32 on the tensor cores: the peak of f32 products
HBM_BPS = 3.35e12            # bytes/s


def least_time(flops: float, nbytes: float,
               peak_flops: float = TF32_FLOPS) -> float:
    """Seconds the chip needs at least: the larger of the operations at
    ``peak_flops`` and the bytes at ``HBM_BPS``."""
    return max(flops / peak_flops, nbytes / HBM_BPS)


def card_power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them, or
    a note that it could not be read."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi not found"
    try:
        out = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=False)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip() or out.stderr.strip()
