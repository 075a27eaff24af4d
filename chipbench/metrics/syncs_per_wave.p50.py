"""Median over the window's waves of the blocking host<->device copies a
wave makes: the count of ``serve.sync.*`` spans that carry the wave's id,
on every thread.  From the program's span log
(``repro_torch.serve.telemetry.SPANS``)."""

from chipbench import program_spans, stats


def read(run):
    spans = program_spans.window(run)
    if spans is None:
        return None
    count, _secs = program_spans.wave_syncs(spans)
    return stats.percentile(count, 50)
