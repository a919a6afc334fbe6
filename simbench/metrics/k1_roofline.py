"""K1's share of its roofline, in %: its bound (bytes over the memory
rate or operations over the float32 rate, ``simbench/roofline.py``)
over its device ms in the frame's instance at the window's last
state."""

from simbench import roofline


def read(ctx):
    probe = ctx.loop.probes().get("k1")
    if probe is None or probe.fn is None:
        return None
    return 100.0 * probe.bound[0] / roofline.device_ms(probe.fn, probe.iters)
