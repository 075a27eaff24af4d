"""The whole step's share of the chip's peak, in percent: the model flops
of the requests answered in the window (the encoder over each turn's
tokens and a corpus scan for each miss; SASRec's blocks and the item
table's scoring) at the TF32 tensor-core peak of 495 TFLOP/s (700 W),
over the seconds in which the system was serving (the union of the waves'
or the requests' service intervals inside the window)."""

from chipbench import hardware


def read(run):
    if run.service_s <= 0:
        return None
    return 100.0 * run.model_flops / (run.service_s * hardware.TF32_FLOPS)
