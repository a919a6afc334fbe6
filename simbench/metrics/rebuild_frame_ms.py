"""Device ms a frame spends in the far-field rebuild, inside its captured
graph: from each of its ``rebuild`` marks to the next mark, summed, mean
over one traced episode's frames (``simbench/spans.py``)."""

from simbench import spans


def read(ctx):
    return spans.frame_ms(ctx, "rebuild")
