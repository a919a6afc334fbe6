"""Directed-CSR general-topology engine: the port of
``softbody_tpu/ops/directed.py``.

The topology is stored DIRECTED: per-particle incidence slots ``[N, D]``
hold the partner index, the edge parameters and a duplicated copy of
the edge's mutable state (target and last length, alive).  Both twins of
an edge compute the identical update from identical operands, so the
only per-substep gather is one ``pos[partner]`` (``[N·D]`` rows), the
force accumulate is a dense row sum, and the edge updates are dense
``[N, D]`` elementwise stores.

Exactness: with ``force_mode="quantized"`` the per-particle force totals
equal the flat path's (``ops/forces.py``) bit for bit: each slot
contributes ``trunc(±f·65536)`` (truncation commutes with negation),
summed in int32, which commutes.  Collisions and integration are the
flat path's (``ops/collisions.py``, ``ops/integrate.py``).

Reference semantics: compute.wgsl:96-131, evaluated once per twin; the
zero-length nudge (compute.wgsl:104-107) applies to the canonical a → b
difference through a per-slot sign, so both twins see the reference's
vector.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import (
    PARTICLE_FORCE_SCALE,
    PhysicsConstants,
    StaticConfig,
    UserInput,
)
from ..state import SimState
from .collisions import collision_terms
from .compiled import Compiled
from .forces import beam_terms
from .integrate import integrate_particles
from .stencil import Scalars, f32_to_i32, frame_scalars


@dataclasses.dataclass
class DirectedState:
    """Particle state + directed incidence tables.

    Every ``[N, D]`` table is slot-major; dead slots point at the owner
    itself with ``slot_alive=False`` and zeroed parameters.
    ``slot_sign`` is +1 where the owner is the edge's ``a`` endpoint
    (canonical a → b difference = sign·(pos[partner] − pos[owner]))."""

    pos: torch.Tensor           # [N, 2] f32
    vel: torch.Tensor
    acc: torch.Tensor
    alive: torch.Tensor         # [N] bool
    pinned: torch.Tensor
    partner: torch.Tensor       # [N, D] int64
    slot_sign: torch.Tensor     # [N, D] int8
    slot_alive: torch.Tensor    # [N, D] bool
    spring: torch.Tensor        # [N, D] f32
    damp: torch.Tensor
    yield_strain: torch.Tensor
    strain_limit: torch.Tensor
    length: torch.Tensor        # rest length
    target: torch.Tensor        # mutable twin
    last: torch.Tensor          # mutable twin
    strain: torch.Tensor        # observability twin
    stress: torch.Tensor

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    @property
    def degree(self) -> int:
        return self.partner.shape[1]


def build_directed(state: SimState, *, min_degree: int = 4,
                   pad_multiple: int = 4):
    """SimState → ``(DirectedState, slot_edge)``, the tables on the
    state's device; ``slot_edge [N, D]`` int32 (host) maps each slot back
    to its flat beam id (−1 on dead slots).  Host-side (NumPy), as the
    JAX package's."""
    dev = state.pos.device
    n = state.max_particles
    a = state.beam_a.cpu().numpy().astype(np.int64)
    b = state.beam_b.cpu().numpy().astype(np.int64)
    m = a.shape[0]
    owners = np.concatenate([a, b])
    partners = np.concatenate([b, a])
    signs = np.concatenate([np.full(m, 1, np.int8), np.full(m, -1, np.int8)])
    edge_ids = np.concatenate([np.arange(m), np.arange(m)])

    order = np.argsort(owners, kind="stable")
    owners, partners = owners[order], partners[order]
    signs, edge_ids = signs[order], edge_ids[order]

    counts = np.bincount(owners, minlength=n)
    max_deg = int(counts.max()) if counts.size else 0
    d = max(min_degree, -(-max(max_deg, 1) // pad_multiple) * pad_multiple)

    partner = np.tile(np.arange(n, dtype=np.int64)[:, None], (1, d))
    slot_sign = np.zeros((n, d), np.int8)
    slot_edge = np.full((n, d), -1, np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)])
    rank = np.arange(owners.shape[0]) - starts[owners]
    partner[owners, rank] = partners
    slot_sign[owners, rank] = signs
    slot_edge[owners, rank] = edge_ids

    def on_dev(arr):
        return torch.from_numpy(arr).to(dev)

    def per_slot(t, fill=0.0):
        out = np.full((n, d), fill, np.float32)
        out[owners, rank] = t.cpu().numpy().astype(np.float32)[edge_ids]
        return on_dev(out)

    slot_alive = np.zeros((n, d), bool)
    slot_alive[owners, rank] = state.beam_alive.cpu().numpy()[edge_ids]

    ds = DirectedState(
        pos=state.pos, vel=state.vel, acc=state.acc,
        alive=state.particle_alive, pinned=state.particle_pinned,
        partner=on_dev(partner), slot_sign=on_dev(slot_sign),
        slot_alive=on_dev(slot_alive),
        spring=per_slot(state.beam_spring),
        damp=per_slot(state.beam_damp),
        yield_strain=per_slot(state.beam_yield_strain, fill=np.inf),
        strain_limit=per_slot(state.beam_strain_limit, fill=np.inf),
        length=per_slot(state.beam_length, fill=1.0),
        target=per_slot(state.beam_target_length, fill=1.0),
        last=per_slot(state.beam_last_length, fill=1.0),
        strain=per_slot(state.beam_strain),
        stress=per_slot(state.beam_stress),
    )
    return ds, slot_edge


def directed_to_sim(ds: DirectedState, template: SimState,
                    slot_edge: np.ndarray) -> SimState:
    """Extraction: each edge's state from its ``a``-side twin (the twins
    are identical by construction) folded back onto the flat beam list,
    on the template's device."""
    se = np.asarray(slot_edge)
    sign = ds.slot_sign.cpu().numpy()
    rows, cols = np.nonzero((se >= 0) & (sign > 0))
    eids = se[rows, cols]
    dev = template.pos.device

    def fold(table, base):
        out = base.cpu().numpy().copy()
        out[eids] = table.cpu().numpy()[rows, cols]
        return torch.from_numpy(out).to(dev)

    return dataclasses.replace(
        template,
        pos=ds.pos, vel=ds.vel, acc=ds.acc,
        particle_alive=ds.alive, particle_pinned=ds.pinned,
        beam_target_length=fold(ds.target, template.beam_target_length),
        beam_last_length=fold(ds.last, template.beam_last_length),
        beam_strain=fold(ds.strain, template.beam_strain),
        beam_stress=fold(ds.stress, template.beam_stress),
        beam_alive=fold(ds.slot_alive, template.beam_alive),
    )


def directed_beam_pass(ds: DirectedState, cfg: StaticConfig):
    """Per-slot spring evaluation + dense row sum.  Returns
    ``(force [N, 2], table updates)``; quantized forces are summed as
    int32 ``trunc(±f·65536)`` per slot."""
    p_part = ds.pos[ds.partner]                       # the gather [N, D, 2]
    alive_part = ds.alive[ds.partner]
    sgn = ds.slot_sign.to(torch.float32)
    # canonical a → b difference (reference orientation), per twin
    ddx = (p_part[..., 0] - ds.pos[:, None, 0]) * sgn
    ddy = (p_part[..., 1] - ds.pos[:, None, 1]) * sgn
    active = ds.slot_alive & ds.alive[:, None] & alive_part
    t = beam_terms(
        ddx, ddy, active, target=ds.target, last=ds.last, length=ds.length,
        spring=ds.spring, damp=ds.damp, yield_strain=ds.yield_strain,
        strain_limit=ds.strain_limit, strain=ds.strain, stress=ds.stress)
    # the force ON the b endpoint is +fmag·d̂; the owner takes ∓ by which
    # endpoint it is: the exact ±1 sign after (fmag·dd)·(1/ln), so
    # quantized totals equal the flat path's
    f_owner = torch.where(active[..., None],
                          torch.stack([-sgn * t.fx, -sgn * t.fy], -1), 0.0)
    upd = {"target": t.target, "last": t.last, "strain": t.strain,
           "stress": t.stress, "slot_alive": ds.slot_alive & ~t.breaks}
    if cfg.force_mode == "quantized":
        q = f32_to_i32(torch.trunc(f_owner * PARTICLE_FORCE_SCALE))
        total = q.sum(dim=1, dtype=torch.int32)
        force = total.to(torch.float32) / PARTICLE_FORCE_SCALE
    else:
        force = f_owner.sum(dim=1)
    return force, upd


def directed_substep(ds: DirectedState, consts: PhysicsConstants,
                     uin: UserInput, cfg: StaticConfig,
                     scalars: Optional[Scalars] = None) -> DirectedState:
    """One substep: the directed beam pass + the flat path's collisions
    and integration (``scalars`` as ``step.substep`` takes them)."""
    beam_force, upd = directed_beam_pass(ds, cfg)
    coll_dv, coll_da, coll_dy = collision_terms(ds.pos, ds.vel, ds.alive,
                                                consts, cfg)
    pos, vel, acc = integrate_particles(
        ds.pos, ds.vel, ds.acc, ds.alive, ds.pinned, coll_dv, coll_da,
        coll_dy, beam_force, consts, uin, cfg, scalars=scalars)
    return dataclasses.replace(ds, pos=pos, vel=vel, acc=acc, **upd)


def _directed_frame(ds: DirectedState, consts: PhysicsConstants,
                    uin: UserInput, cfg: StaticConfig,
                    n_sub: Optional[int] = None) -> DirectedState:
    """One frame: ``cfg.subticks`` substeps (or ``n_sub``)."""
    n = cfg.subticks if n_sub is None else n_sub
    sc = frame_scalars(consts, uin, cfg, 0, ds.pos.device)
    for _ in range(n):
        ds = directed_substep(ds, consts, uin, cfg, scalars=sc)
    return ds


# compiled, as the JAX package's jitted and donating ``directed_frame``
# (``ops/compiled.py``: one CUDA graph per key on the card; the loop
# above, ``directed_frame.__wrapped__``, on the CPU)
directed_frame = Compiled(_directed_frame, static_argnames=("cfg", "n_sub"))
directed_frame_jit = directed_frame
