"""Device idle ms a frame that the program's host phases leave: one
traced episode under ``torch.profiler``, in a process no profiler had
traced before, its idle gaps whose start lies inside a program span (put
down to the innermost), summed, over the episode's frames
(``simbench/spans.py``)."""

from simbench import spans


def read(ctx):
    got = spans.readings(ctx)
    idle = None if got is None else got.get("idle")
    return None if idle is None else idle["ms"]
