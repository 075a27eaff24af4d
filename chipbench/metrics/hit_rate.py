"""Turns 2..n of a conversation answered by the cache, over those turns
(the requests due in the window); each hit saves a corpus scan."""


def read(run):
    later = [r for r in run.completed() if r.turn >= 1 and r.hit is not None]
    if not later:
        return None
    return sum(r.hit for r in later) / len(later)
