"""Device ms a frame spends in its substeps (K1; the planified substep
with K3), inside its captured graph: from each of its ``substep`` marks
to the next mark, summed, mean over one traced episode's frames
(``simbench/spans.py``)."""

from simbench import spans


def read(ctx):
    return spans.frame_ms(ctx, "substep")
