"""Device meshes and collectives of the port's parallel layer: the port of
``softbody_tpu/parallel/mesh.py``.

The JAX package scales two ways over a (dp × sp) mesh: **dp** batches
independent worlds across devices, **sp** splits one world into slabs.
Its ``shard_map`` is single-controller: one process drives every device
of the mesh.  The port keeps that model.  A :class:`Mesh` is a (dp × sp)
grid of ``torch.device``s, and one device may stand in several places
(four shards on one card, eight on the CPU).  A sharded value is a list
of per-shard tensors, and the collectives are plain functions over such
lists: cross-device copies and sums taken in shard order 0…n−1.  That
order is fixed, so a float ``psum`` is reproducible run to run and an
int32 one is exact.

The same code runs each shard on its own card when the mesh names
several, with no launcher: ``torch.distributed`` would need a process
per rank, and NCCL refuses two ranks on one card.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import resolve_device


class Mesh:
    """A 2-D grid of devices with named axes (``jax.sharding.Mesh``'s
    shape).  ``devices`` is an object array ``[dp, sp]``."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, str]):
        if devices.ndim != 2 or len(axis_names) != 2:
            raise ValueError("a mesh is a 2-D device grid with two axis "
                             "names")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def _with_columns(self, axis: str) -> np.ndarray:
        """The device array with ``axis`` as its second dimension."""
        if axis not in self.axis_names:
            raise ValueError(f"no mesh axis {axis!r} in {self.axis_names}")
        return (self.devices if self.axis_names.index(axis) == 1
                else self.devices.T)

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` (the mesh's first line along it: a
        value not split over the other axis lives there; JAX would
        replicate it)."""
        return list(self._with_columns(axis)[0])

    def grid(self, row_axis: str, col_axis: str
             ) -> List[List[torch.device]]:
        """The devices as rows along ``row_axis`` of columns along
        ``col_axis``."""
        if row_axis == col_axis or row_axis not in self.axis_names:
            raise ValueError(f"bad mesh axes {row_axis!r}, {col_axis!r} "
                             f"for {self.axis_names}")
        return [list(r) for r in self._with_columns(col_axis)]


def make_mesh(
    n_devices: Optional[int] = None,
    *,
    dp: Optional[int] = None,
    devices: Optional[Sequence] = None,
    axis_names: Tuple[str, str] = ("dp", "sp"),
) -> Mesh:
    """Build a (dp × sp) mesh over the first ``n_devices`` devices.

    ``devices`` defaults to every CUDA device, and raises if there are
    fewer than ``n_devices``; a mesh of four shards on one card is asked
    for as ``devices=[torch.device("cuda")] * 4``, one on the CPU as
    ``devices=["cpu"] * 8``.  ``dp`` defaults to the largest power of two
    ≤ √n that divides n (JAX's), so both axes get devices; ``dp=1`` is
    pure spatial, ``dp=n`` pure world-parallel."""
    if devices is None:
        resolve_device(None)
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        if n_devices is not None and int(n_devices) > len(devs):
            raise RuntimeError(
                f"{n_devices} devices asked for, {len(devs)} CUDA devices "
                "present: name the devices (devices=[...]) to put several "
                "shards on one")
    else:
        devs = [resolve_device(d) for d in devices]
    if n_devices is not None:
        if int(n_devices) > len(devs):
            raise ValueError(f"{n_devices} devices asked for, "
                             f"{len(devs)} given")
        devs = devs[: int(n_devices)]
    n = len(devs)
    if dp is None:
        dp = 1
        while dp * 2 <= int(np.sqrt(n)) and n % (dp * 2) == 0:
            dp *= 2
    if n % dp != 0:
        raise ValueError(f"{n} devices not divisible by dp={dp}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(dp, n // dp), axis_names)


def pad_to_multiple(n: int, k: int) -> int:
    return -(-n // k) * k


# ---------------------------------------------------------------------------
# collectives over per-shard lists (shard i's tensor on shard i's device)


def ppermute(xs: Sequence[torch.Tensor], perm) -> List[torch.Tensor]:
    """``jax.lax.ppermute``: shard ``dst`` receives ``xs[src]`` for each
    ``(src, dst)`` in ``perm``, zeros where no source names it.  On the
    sender's device the result may be the sender's tensor itself: read
    it, do not write it."""
    out: List[Optional[torch.Tensor]] = [None] * len(xs)
    for src, dst in perm:
        out[dst] = xs[src].to(xs[dst].device)
    return [torch.zeros_like(x) if o is None else o
            for x, o in zip(xs, out)]


def _per_device(xs: Sequence[torch.Tensor], fn) -> List[torch.Tensor]:
    """``fn(device)`` once per distinct device of ``xs``, handed to every
    shard on that device (the shards of one device get one tensor)."""
    done: Dict[torch.device, torch.Tensor] = {}
    out = []
    for x in xs:
        if x.device not in done:
            done[x.device] = fn(x.device)
        out.append(done[x.device])
    return out


def all_gather(xs: Sequence[torch.Tensor], dim: int = 0
               ) -> List[torch.Tensor]:
    """``jax.lax.all_gather(tiled=True)``: the shards' tensors
    concatenated along ``dim`` in shard order, on every shard."""
    return _per_device(xs, lambda dev: torch.cat([x.to(dev) for x in xs],
                                                 dim))


def psum(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``jax.lax.psum``: the shards' tensors summed in shard order
    ``((x0 + x1) + x2) + …`` on every shard."""
    def total(dev):
        acc = xs[0].to(dev)
        for x in xs[1:]:
            acc = acc + x.to(dev)
        return acc

    return _per_device(xs, total)
