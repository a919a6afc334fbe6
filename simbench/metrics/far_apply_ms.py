"""Device ms of one far apply (``ops/farfield4.py``
``bucketed_far_delta_planes``) on the list rebuilt at the window's last
state; nothing where that list is empty."""

from simbench import roofline


def read(ctx):
    probe = ctx.loop.probes().get("far_apply")
    if probe is None or probe.fn is None:
        return None
    return roofline.device_ms(probe.fn, probe.iters)
