"""Spatial sharding of the dense lattice engine with a halo exchange: the
port of ``softbody_tpu/parallel/lattice_spatial.py``.

The ``[W, H]`` lattice is cut into column slabs over the mesh's ``sp``
axis.  Each substep every shard takes ``hx = max(1, collision_stencil)``
ghost columns of the whole :class:`LatticeState` from each neighbour
(``ppermute``), runs the ordinary dense substep (``lattice_substep``;
collisions through kernel K3 under ``cfg.use_pallas``) on the
ghost-extended slab, and keeps the centre:

- every edge and pair with an endpoint in the slab is evaluated from
  true data (both endpoints lie within the ghost ring);
- the ghost columns' own updates are discarded: their owners compute
  them;
- a world-edge shard receives zero ghosts (dead particles at the
  origin), which is the dense path's own border.

Every term of a cell is evaluated from the same values in the same order
as on one device, so a sharded frame equals the single-device
``lattice_frame`` bit for bit.  A sharded lattice is a list of slabs,
shard ``j``'s on its device.

``lattice_spatial_frame_fn`` returns a compiled step
(``parallel/captured.py``), the counterpart of the JAX function's
``jax.jit``: with every slab on one CUDA device the frame is one CUDA
graph per key (the host decisions ``stencil.frame_decisions`` among it:
K3's pair skip), replayed with no host read; on a mesh over several CUDA
devices it runs eagerly, op by op.  It takes the JAX function's
``donate`` and ignores it: the input slabs stay valid and unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List

import torch

from ..config import StaticConfig
from ..ops.stencil import (
    EdgeClass,
    LatticeSpec,
    LatticeState,
    frame_scalars,
    lattice_substep,
)
from .captured import ShardedStep, lattice_decide
from .mesh import Mesh, per_device, ppermute

_PARTICLE = ("pos", "vel", "acc", "alive", "pinned")
_EDGE = tuple(f.name for f in dataclasses.fields(EdgeClass))


def _lattice_map(fn: Callable, *states: LatticeState) -> LatticeState:
    """``fn`` over the matching fields of ``states`` (a tree map)."""
    s0 = states[0]
    return dataclasses.replace(
        s0,
        **{k: fn(*(getattr(s, k) for s in states)) for k in _PARTICLE},
        edges=tuple(
            EdgeClass(**{k: fn(*(getattr(e, k) for e in es)) for k in _EDGE})
            for es in zip(*(s.edges for s in states))))


def _columns(state: LatticeState, start: int, size: int) -> LatticeState:
    return _lattice_map(lambda x: x[start:start + size], state)


def _leaves(state: LatticeState) -> List[torch.Tensor]:
    return ([getattr(state, k) for k in _PARTICLE]
            + [getattr(e, k) for e in state.edges for k in _EDGE])


def _from_leaves(template: LatticeState, leaves) -> LatticeState:
    it = iter(leaves)
    return _lattice_map(lambda _x: next(it), template)


def _ppermute_lattice(states: List[LatticeState], perm) -> List[LatticeState]:
    """``ppermute`` of every field of the shards' states."""
    per_field = [ppermute(list(xs), perm)
                 for xs in zip(*(_leaves(s) for s in states))]
    return [_from_leaves(s, (f[j] for f in per_field))
            for j, s in enumerate(states)]


def shard_lattice(state: LatticeState, mesh: Mesh, *, sp_axis: str = "sp"
                  ) -> List[LatticeState]:
    """Cut ``state`` into column slabs, one per shard of ``sp_axis``, each
    on its device."""
    devs = mesh.axis_devices(sp_axis)
    w = state.shape[0]
    if w % len(devs):
        raise ValueError(f"W={w} not divisible by {len(devs)} devices")
    w_loc = w // len(devs)
    return [_lattice_map(lambda x: x[j * w_loc:(j + 1) * w_loc].to(d)
                         .contiguous(), state)
            for j, d in enumerate(devs)]


def unshard_lattice(slabs: List[LatticeState], device=None) -> LatticeState:
    """The column slabs as one :class:`LatticeState` on ``device``
    (default: the first slab's)."""
    dev = slabs[0].device if device is None else device
    return _lattice_map(lambda *xs: torch.cat([x.to(dev) for x in xs]),
                        *slabs)


def lattice_spatial_frame_fn(
    spec: LatticeSpec,
    cfg: StaticConfig,
    mesh: Mesh,
    *,
    sp_axis: str = "sp",
    donate: bool = True,
) -> ShardedStep:
    """A frame step over the slabs of :func:`shard_lattice`:
    ``step(slabs, consts, uin) → slabs``.  ``spec`` describes the whole
    lattice; W must divide evenly by the axis size.  Every slab on one
    CUDA device: a captured CUDA graph (``step.stats()``); slabs on
    several CUDA devices: eagerly, op by op (``parallel/captured.py``).
    ``donate`` is accepted and ignored (the input stays valid)."""
    n_dev = mesh.shape[sp_axis]
    if spec.width % n_dev:
        raise ValueError(f"W={spec.width} not divisible by {n_dev} devices")
    w_loc = spec.width // n_dev
    hx = max(1, spec.collision_stencil)
    if w_loc < 2 * hx:
        raise ValueError("slab too narrow for the ghost ring")
    ext_spec = dataclasses.replace(spec, width=w_loc + 2 * hx)
    fwd = [(i, i + 1) for i in range(n_dev - 1)]
    bwd = [(i + 1, i) for i in range(n_dev - 1)]

    def substep(slabs, consts, uin, scalars):
        # my rightmost hx columns -> the right neighbour's left ghosts, my
        # leftmost -> the left neighbour's right ghosts; zeros at the edges
        from_left = _ppermute_lattice(
            [_columns(s, w_loc - hx, hx) for s in slabs], fwd)
        from_right = _ppermute_lattice([_columns(s, 0, hx) for s in slabs],
                                       bwd)
        out = []
        for j, s in enumerate(slabs):
            ext = _lattice_map(lambda a, b, c: torch.cat([a, b, c]),
                               from_left[j], s, from_right[j])
            ext = lattice_substep(ext, consts, uin, ext_spec, cfg,
                                  lin_x_offset=j * w_loc - hx,
                                  scalars=scalars[s.device])
            out.append(_columns(ext, hx, w_loc))
        return out

    def frame(slabs, consts, uin):
        # the consts vector once a frame on each slab's device
        scalars = per_device(slabs, lambda d: frame_scalars(
            consts, uin, cfg, spec.height, d))
        for _ in range(cfg.subticks):
            slabs = substep(slabs, consts, uin, scalars)
        return slabs

    def step(run, slabs: List[LatticeState], consts, uin
             ) -> List[LatticeState]:
        if len(slabs) != n_dev:
            raise ValueError(f"{len(slabs)} slabs for {n_dev} shards")
        return run(list(slabs), consts, uin)

    return ShardedStep(frame, step, devices=mesh.axis_devices(sp_axis),
                       decide=lattice_decide(cfg))
