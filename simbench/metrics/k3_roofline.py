"""K3's share of its roofline, in %: its bound over its device ms on the
embedding's planes at the window's last state."""

from simbench import roofline


def read(ctx):
    probe = ctx.loop.probes().get("k3")
    if probe is None or probe.fn is None:
        return None
    return 100.0 * probe.bound[0] / roofline.device_ms(probe.fn, probe.iters)
