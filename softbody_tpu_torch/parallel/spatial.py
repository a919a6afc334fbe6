"""Spatial (sp) sharding of the general engine: the port of
``softbody_tpu/parallel/spatial.py``.  One world, particles and beams cut
into index slabs, one slab per shard of the mesh's ``sp`` axis.

Each substep (``_substep``, the JAX ``_local_substep``):

1. ``all_gather`` of positions, velocities and alive over ``sp``: every
   shard sees the whole world's kinematics (a beam or a collision may
   reach any particle);
2. the shard's beam slab against the gathered world;
3. its endpoint forces summed per particle over the whole world and
   ``psum``-ed over ``sp``; each shard keeps its own rows.  With
   ``force_mode="quantized"`` the sums are int32 (exact in any order, so
   bit-identical at any shard count); in float32 each shard sums in list
   order (``stencil.index_sum``) and the ``psum`` in shard order;
4. the slab's collisions against the gathered world
   (``collision_terms(query=)``);
5. the slab's integration.

The beam pass keeps the JAX sharded function's own float32 expressions,
``force_mag · (diff / len)`` and ``force_mag / 20``, not the single-device
pass's ``(force_mag · diff) · (1/len)`` and ``force_mag · 0.05``
(``softbody_tpu/parallel/spatial.py:117``, ``:132``): against the
single-device frame a force or a stress may differ by an ulp.

A sharded world is a :class:`ShardedState`: the slabs as rows along the
``dp`` axis (one row without it) of columns along ``sp``.  With
``dp_axis`` each slab carries a leading batch dimension (a batch of
worlds split over ``dp``, each world over ``sp``); the worlds of a row
are stepped one after another, as ``jax.vmap`` steps them side by side.
The CSR incidence is a single-device gather and is dropped.

``spatial_frame_fn`` takes the JAX function's ``donate`` and ignores it:
each substep makes new tensors and leaves its input as it was.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ..config import PARTICLE_FORCE_SCALE, StaticConfig
from ..ops.collisions import collision_terms
from ..ops.integrate import integrate_particles
from ..ops.stencil import device_scalar, f32_to_i32, index_sum, sqrt32
from ..state import PARTICLE_FIELDS, SimState
from .batched import stack_states, state_fields, unstack_states
from .mesh import Mesh, all_gather, pad_to_multiple, psum

# dead padding (JAX's fill values): beam lengths and strain bounds 1
_BEAM_FILL = {"beam_length": 1.0, "beam_target_length": 1.0,
              "beam_last_length": 1.0, "beam_yield_strain": 1.0,
              "beam_strain_limit": 1.0}


@dataclasses.dataclass
class ShardedState:
    """A world (or a batch of worlds) split over a mesh: ``shards[i][j]``
    is the slab of row ``i`` (a ``dp`` index) and column ``j`` (an
    ``sp`` index), on that shard's device.  ``batched``: every slab has
    a leading batch dimension."""

    shards: List[List[SimState]]
    batched: bool


def _drop_incidence(state: SimState) -> SimState:
    if state.inc_beam is None:
        return state
    return dataclasses.replace(state, inc_beam=None, inc_sign=None)


def pad_state_for_mesh(state: SimState, sp: int) -> SimState:
    """Pad the particle and beam capacities (the leading dimension) to
    multiples of ``sp`` with dead entries; the incidence is dropped."""
    n, m = state.max_particles, state.max_beams
    n2, m2 = pad_to_multiple(n, sp), pad_to_multiple(m, sp)
    state = _drop_incidence(state)
    if n2 == n and m2 == m:
        return state

    def pad(name):
        x = getattr(state, name)
        size = n2 if name in PARTICLE_FIELDS else m2
        out = torch.full((size,) + tuple(x.shape[1:]),
                         _BEAM_FILL.get(name, 0), dtype=x.dtype,
                         device=x.device)
        out[: x.shape[0]] = x
        return out

    return SimState(**{name: pad(name) for name in state_fields(state)})


def _split(state: SimState, n_parts: int, dim: int) -> List[SimState]:
    """``state`` cut along ``dim`` of every field into ``n_parts`` equal
    contiguous parts."""
    parts = {}
    for name, x in state_fields(state).items():
        if x.shape[dim] % n_parts:
            raise ValueError(f"{name}: {x.shape[dim]} not divisible by "
                             f"{n_parts} shards")
        parts[name] = torch.chunk(x, n_parts, dim=dim)
    return [SimState(**{name: p[i] for name, p in parts.items()})
            for i in range(n_parts)]


def _cat(states: List[SimState], dim: int, device) -> SimState:
    return SimState(**{name: torch.cat([getattr(s, name).to(device)
                                        for s in states], dim)
                       for name in state_fields(states[0])})


def _to(state: SimState, device) -> SimState:
    return SimState(**{name: x.to(device).contiguous()
                       for name, x in state_fields(state).items()})


def shard_state(state: SimState, mesh: Mesh, *, sp_axis: str = "sp",
                dp_axis: Optional[str] = None) -> ShardedState:
    """Place a (pre-padded) state on the mesh in slabs: particles and
    beams over ``sp_axis``; with ``dp_axis``, a batched state's worlds
    over it too."""
    grid = (mesh.grid(dp_axis, sp_axis) if dp_axis
            else [mesh.axis_devices(sp_axis)])
    state = _drop_incidence(state)
    rows = _split(state, len(grid), 0) if dp_axis else [state]
    return ShardedState(
        shards=[[_to(slab, dev) for slab, dev in
                 zip(_split(row, len(devs), 1 if dp_axis else 0), devs)]
                for row, devs in zip(rows, grid)],
        batched=dp_axis is not None)


def unshard_state(sharded: ShardedState, device=None) -> SimState:
    """The sharded world (or batch) as one :class:`SimState` on
    ``device`` (default: the first shard's)."""
    dev = sharded.shards[0][0].pos.device if device is None else device
    dim = 1 if sharded.batched else 0
    rows = [_cat(row, dim, dev) for row in sharded.shards]
    return _cat(rows, 0, dev) if sharded.batched else rows[0]


def _beam_slab(s: SimState, pos_full, alive_full):
    """The beam half of compute.wgsl:94-131 on the slab's beams, in the
    JAX sharded function's float32 expressions.  Returns the masked force
    on endpoint b ``[m, 2]`` and the updated beam fields."""
    a, b = s.beam_a, s.beam_b
    active = s.beam_alive & alive_full[a] & alive_full[b]
    diff = pos_full[b] - pos_full[a]
    raw_len = sqrt32(diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1])
    zero = raw_len == 0.0
    diff = torch.stack([torch.where(zero, 0.0, diff[:, 0]),
                        torch.where(zero, -1.0e-10, diff[:, 1])], -1)
    length_now = torch.where(zero, 1.0e-10, raw_len)
    force_mag = ((s.beam_target_length - length_now) * s.beam_spring
                 + (s.beam_last_length - length_now) * s.beam_damp)
    force_vec = force_mag[:, None] * (diff / length_now[:, None])
    strain = (length_now - s.beam_target_length) / s.beam_length
    yielded = strain.abs() > s.beam_yield_strain
    new_target = torch.where(
        yielded,
        length_now - s.beam_yield_strain * s.beam_length * torch.sign(strain),
        s.beam_target_length)
    breaks = ((length_now - s.beam_length).abs()
              > s.beam_length * s.beam_strain_limit)
    upd = {
        "beam_target_length": torch.where(active, new_target,
                                          s.beam_target_length),
        "beam_last_length": torch.where(active, length_now,
                                        s.beam_last_length),
        # a true division on every device (stencil.device_scalar)
        "beam_stress": torch.where(
            active, force_mag / device_scalar(20.0, force_mag.device),
            s.beam_stress),
        "beam_strain": torch.where(active,
                                   strain.abs() / s.beam_yield_strain,
                                   s.beam_strain),
        "beam_alive": s.beam_alive & ~(active & breaks),
    }
    return torch.where(active[:, None], force_vec, 0.0), upd


def _substep(slabs: List[SimState], consts, uin,
             cfg: StaticConfig) -> List[SimState]:
    """One substep of one world over its sp slabs (``slabs[j]`` on shard
    ``j``'s device)."""
    n_loc = slabs[0].max_particles
    quantized = cfg.force_mode == "quantized"
    # (1) the world's kinematics on every shard
    pos_full = all_gather([s.pos for s in slabs])
    vel_full = all_gather([s.vel for s in slabs])
    alive_full = all_gather([s.particle_alive for s in slabs])
    n = pos_full[0].shape[0]

    # (2)-(3) the slab's beams, their endpoint sums over the world, psum
    partial, upds = [], []
    for j, s in enumerate(slabs):
        fv, upd = _beam_slab(s, pos_full[j], alive_full[j])
        upds.append(upd)
        ids = torch.cat([s.beam_a, s.beam_b])
        if quantized:
            q = f32_to_i32(torch.trunc(fv * PARTICLE_FORCE_SCALE))
            partial.append(torch.zeros((n, 2), dtype=torch.int32,
                                       device=q.device).index_add_(
                0, ids, torch.cat([-q, q])))
        else:
            partial.append(index_sum(ids, torch.cat([-fv, fv]), n))
    totals = psum(partial)

    out = []
    for j, s in enumerate(slabs):
        lo = j * n_loc
        beam_force = totals[j][lo : lo + n_loc]
        if quantized:
            beam_force = beam_force.to(torch.float32) / PARTICLE_FORCE_SCALE
        # (4) the slab against the gathered world
        idx_q = torch.arange(lo, lo + n_loc, device=s.pos.device)
        coll_dv, coll_da, coll_dy = collision_terms(
            pos_full[j], vel_full[j], alive_full[j], consts, cfg,
            query=(pos_full[j][lo : lo + n_loc], vel_full[j][lo : lo + n_loc],
                   s.particle_alive, idx_q))
        # (5) the slab's integration
        pos, vel, acc = integrate_particles(
            s.pos, s.vel, s.acc, s.particle_alive, s.particle_pinned,
            coll_dv, coll_da, coll_dy, beam_force, consts, uin, cfg)
        out.append(dataclasses.replace(s, pos=pos, vel=vel, acc=acc,
                                       **upds[j]))
    return out


def spatial_frame_fn(
    cfg: StaticConfig,
    mesh: Mesh,
    *,
    sp_axis: str = "sp",
    dp_axis: Optional[str] = None,
    donate: bool = True,
):
    """A frame step over a :class:`ShardedState` laid out by
    :func:`shard_state` with the same axes: ``step(sharded, consts, uin)
    → ShardedState``.  Beam endpoint indices are global, so a beam may
    join particles of different shards."""
    n_sp = mesh.shape[sp_axis]

    def frame_world(slabs, consts, uin):
        for _ in range(cfg.subticks):
            slabs = _substep(slabs, consts, uin, cfg)
        return slabs

    def step(sharded: ShardedState, consts, uin) -> ShardedState:
        if sharded.batched != (dp_axis is not None):
            raise ValueError("the state was sharded with other axes")
        rows = []
        for row in sharded.shards:
            if len(row) != n_sp:
                raise ValueError(f"{len(row)} slabs for {n_sp} sp shards")
            if not sharded.batched:
                rows.append(frame_world(row, consts, uin))
                continue
            worlds = [frame_world(list(slabs), consts, uin) for slabs in
                      zip(*[unstack_states(s) for s in row])]
            rows.append([stack_states([w[j] for w in worlds])
                         for j in range(n_sp)])
        return ShardedState(shards=rows, batched=sharded.batched)

    return step
