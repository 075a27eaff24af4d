"""The expert products' share of their roofline, in percent: the least
time of the routed and shared expert products of each call of
``models.moe.expert_products`` (``costs_mla_moe``: 2 x 3 x d x f
operations a real token through an expert at the dense bf16 peak of 989
TFLOP/s, or the weights of each expert that took a token and the token
rows in and out once at 3.35 TB/s, whichever is longer; the peaks assume
the 700 W power limit) over the device time of the kernels launched
inside the benchmark's ``cb.experts`` ranges, in the traced window.  The
ranges nest inside ``cb.encoder``; no other metric divides the encoder's
operations by what is left of its range."""

from chipbench import costs_mla_moe, hardware, readers


def read(run):
    return readers.percent(readers.device_share(
        run, "experts", lambda c: hardware.least_time(
            c.flops, c.nbytes, costs_mla_moe.BF16_FLOPS)))
