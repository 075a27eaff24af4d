"""Median of the program's ``serve.encode`` spans that began in the
window, in ms: the host seconds of each call of the query encoder (a
wave's in ``BatchedEngine.probe_wave``; ``SeqRec.session_repr`` in a
retrieval request), which is its launches: the device may still be
running what they queued.  From the program's span log
(``repro_torch.serve.telemetry.SPANS``)."""

from chipbench import program_spans, stats


def read(run):
    spans = program_spans.window(run)
    if spans is None:
        return None
    return stats.percentile(program_spans.durations_ms(spans,
                                                       "serve.encode"), 50)
