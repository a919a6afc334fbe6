"""World-parallel (dp) simulation: the port of
``softbody_tpu/parallel/batched.py``.  A batch of independent worlds is
split over the mesh's ``dp`` devices, and each device steps its own
worlds through ``ops/step.frame``.  No world talks to another.

The JAX package steps a device's worlds side by side with ``jax.vmap``.
The port steps them one after another: ``torch.vmap`` refuses the frame
as written wherever it writes a batched value into a fresh tensor in
place, the force pass of a world without an incidence (``index_add_``
into a new accumulator) and the ``window`` broad phase (its sorted
table).  The loop takes every world, and each world stays bit-identical
to its own single-device frame.

A batch on the mesh is a list of batched states, one per ``dp`` device,
each holding that device's share of the worlds in order.

The step is compiled (``parallel/captured.py``), the counterpart of the
JAX step's ``jax.jit``: a device's worlds are one CUDA graph on that
device (no collective joins the devices, so this holds on a mesh over
several cards too), replayed with no host read; the input batches stay
valid and unchanged.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import torch

from ..config import PhysicsConstants, StaticConfig, UserInput
from ..ops.step import frame
from ..state import SimState
from .captured import ShardedStep
from .mesh import Mesh


def state_fields(state: SimState) -> dict:
    """The state's fields that hold a tensor (the incidence may not)."""
    return {k: v for k, v in vars(state).items() if v is not None}


def stack_states(states: Sequence[SimState]) -> SimState:
    """Stack same-capacity worlds along a new leading batch axis."""
    names = state_fields(states[0])
    return SimState(**{k: torch.stack([getattr(s, k) for s in states])
                       for k in names})


def unstack_states(batched: Union[SimState, Sequence[SimState]]
                   ) -> List[SimState]:
    """The worlds of a batched state, or of the per-device batches that
    :func:`device_put_batched` makes, in order."""
    if isinstance(batched, SimState):
        batched = [batched]
    out = []
    for part in batched:
        f = state_fields(part)
        out += [SimState(**{k: v[i] for k, v in f.items()})
                for i in range(part.pos.shape[0])]
    return out


def device_put_batched(states: SimState, mesh: Mesh, axis: str = "dp"
                       ) -> List[SimState]:
    """Split a batched state's worlds over ``mesh[axis]`` in equal
    contiguous parts, each on its device."""
    devs = mesh.axis_devices(axis)
    b = states.pos.shape[0]
    if b % len(devs):
        raise ValueError(f"{b} worlds not divisible by {len(devs)} devices")
    k = b // len(devs)
    return [SimState(**{n: v[i * k:(i + 1) * k].to(d).contiguous()
                        for n, v in state_fields(states).items()})
            for i, d in enumerate(devs)]


def batched_frame_fn(cfg: StaticConfig, mesh: Mesh,
                     axis: str = "dp") -> ShardedStep:
    """A frame step over the per-device batches of
    :func:`device_put_batched`: ``step(batches, consts, uin) →
    batches``, each device's worlds stepped by ``frame`` in turn, as one
    captured CUDA graph per device on the card (``step.stats()``).  The
    constants and input are shared by every world."""
    n_dev = mesh.shape[axis]

    def frame_part(part: SimState, consts: PhysicsConstants,
                   uin: UserInput) -> SimState:
        return stack_states([frame(w, consts, uin, cfg)
                             for w in unstack_states(part)])

    def step(run, batches: Sequence[SimState], consts: PhysicsConstants,
             uin: UserInput) -> List[SimState]:
        if len(batches) != n_dev:
            raise ValueError(f"{len(batches)} batches for {n_dev} devices")
        return [run(part, consts, uin) for part in batches]

    return ShardedStep(frame_part, step)
