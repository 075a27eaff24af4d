"""Median latency of the requests due in the window, from the moment each
was due to its answer (host clock)."""

from chipbench import readers, stats


def read(run):
    return stats.percentile(readers.latencies_ms(run), 50)
