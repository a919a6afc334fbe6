"""The device's idle share over the window, in %: 1 − (one episode's
device ms, each frame queued behind ``torch.cuda._sleep`` and timed
alone) / (the window's mean episode ms).  Not the profiler's reading,
which stretches short kernels."""


def read(ctx):
    return 100.0 * (1.0 - ctx.loop.device_episode_ms()
                    / ctx.loop.window_episode_ms())
