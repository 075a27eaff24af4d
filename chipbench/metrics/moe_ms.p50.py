"""Median of the program's ``serve.moe`` spans that began in the window,
in ms: the host seconds of one MoE layer of the dropless path (route,
dispatch, the expert products, combine), which is its launches: the
device may still be running what they queued.  From the program's span
log (``repro_torch.serve.telemetry.SPANS``)."""

from chipbench import program_spans, stats


def read(run):
    spans = program_spans.window(run)
    if spans is None:
        return None
    return stats.percentile(program_spans.durations_ms(spans, "serve.moe"),
                            50)
