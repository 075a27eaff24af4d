"""The query encoder's share of the chip's peak, in percent: the
operations of the rows each encoder call was handed (``costs.encoder_flops``
over their real tokens) at the TF32 tensor-core peak (495 TFLOP/s: f32
products, see ``hardware.py``), over the device time of the kernels
launched inside the benchmark's ``cb.encoder`` ranges in the traced
window.  HBM 3.35 TB/s; the peaks assume the 700 W power limit."""

from chipbench import readers


def read(run):
    return readers.percent(readers.tf32_share(run, "encoder"))
