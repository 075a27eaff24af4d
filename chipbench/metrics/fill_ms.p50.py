"""Median of ``TurnSpans.insert_s`` (the wave's fill: the fused insert and
query of ``core/cache.BatchedMetricCache`` through
``BatchedEngine.fill_wave``) over the window's waves."""

from chipbench import readers


def read(run):
    return readers.span_percentile(
        [w["spans"][0].insert_s for w in run.waves if w["spans"]], 50)
