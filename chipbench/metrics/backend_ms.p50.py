"""Median of ``TurnSpans.backend_s`` (the router's search of a wave's
misses: ``serve/router.ShardedRouter`` -> ``dist/retrieval.DeviceShard``)
over the window's waves that had misses."""

from chipbench import readers


def read(run):
    return readers.span_percentile(
        [w["spans"][0].backend_s for w in run.waves
         if any(s.tier == "backend" for s in w["spans"])], 50)
