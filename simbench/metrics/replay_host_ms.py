"""Host ms of a frame's compiled call (``compiled.call`` less
``compiled.capture``: the key, the lock, the copies in, the replay, the
clones out), median over one traced episode's frames, in a process
that no profiler has traced (``simbench/spans.py``)."""

from simbench import spans


def read(ctx):
    got = spans.readings(ctx)
    return None if got is None else got.get("replay_host_ms")
