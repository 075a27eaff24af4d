"""Requests answered soundly inside the window, over its seconds."""


def read(run):
    n = sum(1 for r in run.requests if r.ok and run.in_window(r.done))
    return n / run.window_s
