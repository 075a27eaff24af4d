"""Share of the traced window in which no device activity (kernel, copy,
fill) ran, in percent, from the profiler's timeline."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
