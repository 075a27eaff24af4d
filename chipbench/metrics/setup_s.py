"""Seconds from the process's start to the window's opening: imports,
inputs made from the seed, the program built and warmed, the load
started (``run.setup_s``)."""


def read(run):
    return run.setup_s
