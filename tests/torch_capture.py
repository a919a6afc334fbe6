"""Stand-ins for checking captured frames on the CPU: ``RecordingGraph``,
a graph type for ``compiled.Compiled`` that re-runs the function on
replay (the cache's logic without a card), and ``no_host_reads()``, a
guard that makes any read of a tensor's value on the host raise (what
fails a CUDA-graph capture on the card).  JAX-free."""

import contextlib
import sys

import torch

from softbody_tpu_torch.ops import compiled


class RecordingGraph:
    """Stand-in for ``compiled.CudaGraph`` on CPU tensors: the warm-up
    runs the function; capture runs it and keeps it; replay runs it again
    on the static inputs and copies the results into the captured
    outputs, with the launch counters left as they were (a CUDA graph's
    replay runs no Python)."""

    device_type = "cpu"

    def __init__(self, device):
        self.device = device

    def warm_up(self, run):
        run()

    def capture(self, run):
        self.run = run
        self.out = run()
        return self.out

    def replay(self):
        counts = compiled.read_counts()
        fresh = self.run()
        compiled.set_counts(counts)
        for dst, src in zip(compiled.tensors(self.out),
                            compiled.tensors(fresh)):
            dst.copy_(src)


# where a read or a host copy stands for what the card does without one:
# the eager branch reads, a constant table's one copy (made by the
# warm-up), the kernels' plain versions
_ALLOWED = {"host_read", "device_constant", "fused_substep2_plain",
            "band_flags_plain", "mirror_records_plain",
            "collide_stencil_plain"}
_READS = ("item", "tolist", "__bool__", "__int__", "__float__",
          "__index__")


def _allowed() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name in _ALLOWED:
            return True
        f = f.f_back
    return False


@contextlib.contextmanager
def no_host_reads():
    """Every read of a tensor's value on the host, every tensor made on a
    device from host data and every host number assigned into a tensor
    raises outside :data:`_ALLOWED`."""
    saved = {n: getattr(torch.Tensor, n) for n in _READS + ("__setitem__",)}
    makers = {n: getattr(torch, n) for n in ("tensor", "as_tensor")}

    def read(name):
        orig = saved[name]

        def guarded(self, *args, **kwargs):
            if not _allowed():
                raise AssertionError(f"host read in a frame: Tensor.{name}")
            return orig(self, *args, **kwargs)
        return guarded

    def make(name):
        orig = makers[name]

        def guarded(*args, **kwargs):
            if kwargs.get("device") is not None and not _allowed():
                raise AssertionError(f"host copy in a frame: torch.{name}")
            return orig(*args, **kwargs)
        return guarded

    def setitem(self, index, value):
        # a host number assigned into a device tensor is copied from the
        # host
        if not isinstance(value, torch.Tensor) and not _allowed():
            raise AssertionError("host copy in a frame: a number assigned "
                                 "into a tensor")
        return saved["__setitem__"](self, index, value)

    try:
        for n in _READS:
            setattr(torch.Tensor, n, read(n))
        torch.Tensor.__setitem__ = setitem
        for n in makers:
            setattr(torch, n, make(n))
        yield
    finally:
        for n, fn in saved.items():
            setattr(torch.Tensor, n, fn)
        for n, fn in makers.items():
            setattr(torch, n, fn)
