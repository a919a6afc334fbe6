"""The general engine's physics step: the port of
``softbody_tpu/ops/step.py``.  One substep is one ``compute_update``
dispatch (compute.wgsl:90-203); a frame is ``cfg.subticks`` substeps
(the reference encodes 64 per frame, engineWorker.ts:646-665).

Both the beam and the particle pass of a substep read the incoming
state and the substep returns a new one: the reference's particle
double-buffering (engineWorker.ts:655-658).  The JAX package runs a
frame as one ``lax.scan``; eager torch runs it as a Python loop.

``substep_jit`` and ``frame_jit`` are the compiled counterparts of the
JAX package's jitted functions (``ops/compiled.py``): on CUDA tensors a
frame is one CUDA graph of its ``cfg.subticks`` substeps, captured once
per key and replayed; on CPU tensors they run ``substep`` and ``frame``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..config import PhysicsConstants, StaticConfig, UserInput
from ..state import SimState
from .collisions import collision_terms
from .compiled import Compiled
from .forces import accumulate_forces, beam_forces
from .integrate import integrate_particles
from .stencil import Scalars, frame_scalars


def substep(state: SimState, consts: PhysicsConstants, uin: UserInput,
            cfg: StaticConfig, scalars: Optional[Scalars] = None) -> SimState:
    """One physics substep (a new state; the input is not modified).
    ``scalars``: the consts vector's :class:`~.stencil.Scalars`, where the
    caller formed them (a frame does, once)."""
    force_vec, beam_upd, _breaks = beam_forces(state, cfg)
    beam_force = accumulate_forces(state, force_vec, cfg)
    coll_dv, coll_da, coll_dy = collision_terms(
        state.pos, state.vel, state.particle_alive, consts, cfg)
    pos, vel, acc = integrate_particles(
        state.pos, state.vel, state.acc, state.particle_alive,
        state.particle_pinned, coll_dv, coll_da, coll_dy, beam_force,
        consts, uin, cfg, scalars=scalars)
    return dataclasses.replace(state, pos=pos, vel=vel, acc=acc, **beam_upd)


def frame(state: SimState, consts: PhysicsConstants, uin: UserInput,
          cfg: StaticConfig) -> SimState:
    """One frame: ``cfg.subticks`` substeps."""
    sc = frame_scalars(consts, uin, cfg, 0, state.pos.device)
    for _ in range(cfg.subticks):
        state = substep(state, consts, uin, cfg, scalars=sc)
    return state


substep_jit = Compiled(substep, static_argnames=("cfg",))

# the hot entry point of the runtime (``SimBackend.step``) and the CLI
frame_jit = Compiled(frame, static_argnames=("cfg",))


def run_frames(state: SimState, consts: PhysicsConstants, uin: UserInput,
               cfg: StaticConfig, num_frames: int) -> SimState:
    """``num_frames`` frames through ``frame_jit``, one after another
    (benchmarks, tests)."""
    for _ in range(num_frames):
        state = frame_jit(state, consts, uin, cfg)
    return state
