"""95th percentile of ``TurnSpans.queue_wait_s`` (admission to the start
of the turn's wave: the front door, ``serve/session.SessionManager`` and
``serve/scheduler.ContinuousScheduler``) over the turns of the waves that
ended in the window."""

from chipbench import readers


def read(run):
    return readers.span_percentile([s.queue_wait_s for s in run.spans], 95)
