"""Device ms of one far-field rebuild (``ops/farfield.py``
``rebuild_far_list_planes``, with K2) at the window's last state: the
device operations of 5 calls in the profiler's trace, summed, over 5.
The rebuild reads its counts on the host eagerly; those waits are not
counted."""

from simbench import roofline


def read(ctx):
    probe = ctx.loop.probes().get("rebuild")
    if probe is None or probe.fn is None:
        return None
    return roofline.traced_ms(probe.fn, probe.iters)
