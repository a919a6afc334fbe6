"""The sharded frames' compiled steps: the port's counterpart of the
``jax.jit`` around each ``shard_map`` frame of the JAX package's
parallel layer (``softbody_tpu/parallel/*.py``).

A frame function of the parallel layer closes over its mesh layout, its
``spec`` / ``cfg`` / ``ffspec`` and its schedule, so these act as
``jax.jit``'s static arguments: one :class:`~..ops.compiled.Compiled`
per step, keyed by the tensors' layouts and the frame's host decisions.
Where it runs:

- every shard on one CUDA device (a mesh of ``devices=[cuda] * n``):
  one CUDA graph per key, captured at the first call and replayed with
  no host read after it; the constants and the user input are lifted
  into its device buffer, so a drag replays one graph;
- shards on several CUDA devices: the frame runs eagerly, op by op.
  ``Compiled`` captures the tensors of one device, and a frame over
  several cards needs one graph per device between its collectives,
  which is not written yet;
- on the CPU: the frame runs, as ``Compiled`` runs it there.

A step given no devices (``batched``: no collective, one call per
device) always calls its ``Compiled``, whose key holds the device: one
graph per device of the mesh.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..ops.compiled import Compiled
from ..ops.stencil import host_decisions


def lattice_decide(cfg) -> Callable:
    """A frame's ``decide`` (``stencil.frame_decisions``) with ``cfg`` a
    closure constant of its step: the kernels' pair skip and
    ``drag_exp == 2`` from the host constants."""
    def decide(arguments: dict):
        c = arguments["consts"]
        return host_decisions(cfg.particle_radius, cfg.dt, c.ecoeff,
                              c.friction, c.drag_exp)
    return decide


class ShardedStep:
    """A sharded frame step.  ``core`` computes the frame on tensors (the
    part a graph captures); ``wrap(run, *args)`` is the step a user
    calls, which checks its arguments, calls ``run`` (``core`` or its
    ``Compiled``) and shapes the result.

    ``devices``: the devices the step's shards lie on; on one device the
    step runs ``core`` through its ``Compiled``, on several eagerly
    (None: always through the ``Compiled``).  ``decide``: the frame's
    host decisions (``Compiled(decide=)``).

    :meth:`eager` is the same step op by op (the twin a capture is held
    to); :meth:`stats` the ``Compiled``'s misses, captures, replays and
    graphs; ``compiled`` the ``Compiled`` itself."""

    def __init__(self, core: Callable, wrap: Callable, *,
                 devices: Optional[Sequence] = None,
                 decide: Optional[Callable] = None) -> None:
        self.core = core
        self.wrap = wrap
        self.compiled = Compiled(core, decide=decide)
        self.captured = (devices is None
                         or len({torch.device(d) for d in devices}) == 1)

    def __call__(self, *args, **kwargs):
        return self.wrap(self.compiled if self.captured else self.core,
                         *args, **kwargs)

    def eager(self, *args, **kwargs):
        return self.wrap(self.core, *args, **kwargs)

    def stats(self) -> dict:
        return self.compiled.stats()
