"""Kernel records (copies and fills left out) in the profiler's trace of
one episode, over the episode's substeps."""


def read(ctx):
    prof = ctx.loop.profile()
    return prof["kernels"] / prof["substeps"]
