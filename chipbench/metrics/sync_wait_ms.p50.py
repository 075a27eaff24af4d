"""Median over the window's waves of the seconds a wave's host waited in
blocking host<->device copies, in ms: the summed ``serve.sync.*`` spans
that carry the wave's id, on every thread (the worker, the back-end
thread and the router's pool).  From the program's span log
(``repro_torch.serve.telemetry.SPANS``)."""

from chipbench import program_spans, stats


def read(run):
    spans = program_spans.window(run)
    if spans is None:
        return None
    _count, secs = program_spans.wave_syncs(spans)
    return stats.percentile(secs * 1e3, 50)
