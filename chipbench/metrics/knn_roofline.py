"""The exact kNN search's share of its roofline, in percent: the least
time of each search (``costs.knn_search``: 2 B N D operations at the TF32
tensor-core peak of 495 TFLOP/s, or the stored corpus, the queries and the
(B, k) answer once each at 3.35 TB/s, whichever is longer; the peaks
assume the 700 W power limit) over the device time of the kernels
launched inside the benchmark's ``cb.knn`` ranges around the index's
search, in the traced window."""

from chipbench import readers


def read(run):
    return readers.percent(readers.roofline_share(run, "knn"))
