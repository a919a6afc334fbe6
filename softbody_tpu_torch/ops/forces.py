"""Beam (spring + damper) force pass of the general engine: the port of
``softbody_tpu/ops/forces.py`` (the beam half of ``compute_update``,
compute.wgsl:94-131).

Per live beam, reading the previous substep's particle state: the
zero-length guard ``diff ← (0, −1e-10)``, ``force_mag = (target − len)
·spring + (last − len)·damp``, plastic yield, the breakage mark, the
strain/stress observability channels, and equal and opposite endpoint
forces.  A beam that breaks still applies its force in the substep it
breaks in and is dead from the next one.

The float32 expressions and their order are the JAX package's
(``(fmag·diff)·(1/len)``); square roots go through ``stencil.sqrt32``,
so the quantized sums are bit-exact against it.
"""

from __future__ import annotations

import torch

from ..config import BEAM_STRESS_SCALE, PARTICLE_FORCE_SCALE, StaticConfig
from ..state import SimState
from .stencil import f32_to_i32, sqrt32


def beam_forces(state: SimState, cfg: StaticConfig):
    """Per-beam endpoint forces and the updated beam state.

    Returns ``(force_vec [M, 2]`` — the force on endpoint b; endpoint a
    receives its negation —, the dict of updated ``beam_*`` fields, the
    break mask ``[M]``)."""
    pos = state.pos
    a, b = state.beam_a, state.beam_b
    # a beam is active only when it and both its endpoints are alive
    active = (state.beam_alive & state.particle_alive[a]
              & state.particle_alive[b])

    diff = pos[b] - pos[a]
    dx, dy = diff[:, 0], diff[:, 1]
    raw_len = sqrt32(dx * dx + dy * dy)
    zero = raw_len == 0.0
    # compute.wgsl:104-107 — nudge to (0, -1e-10) to avoid 0/0
    dx = torch.where(zero, 0.0, dx)
    dy = torch.where(zero, -1.0e-10, dy)
    length_now = torch.where(zero, 1.0e-10, raw_len)

    force_mag = ((state.beam_target_length - length_now) * state.beam_spring
                 + (state.beam_last_length - length_now) * state.beam_damp)
    inv_len = torch.reciprocal(length_now)
    force_vec = torch.stack([(force_mag * dx) * inv_len,
                             (force_mag * dy) * inv_len], dim=-1)

    strain = (length_now - state.beam_target_length) / state.beam_length
    yielded = strain.abs() > state.beam_yield_strain
    new_target = torch.where(
        yielded,
        length_now - state.beam_yield_strain * state.beam_length
        * torch.sign(strain),
        state.beam_target_length)
    breaks = ((length_now - state.beam_length).abs()
              > state.beam_length * state.beam_strain_limit)

    upd = {
        "beam_target_length": torch.where(active, new_target,
                                          state.beam_target_length),
        "beam_last_length": torch.where(active, length_now,
                                        state.beam_last_length),
        "beam_stress": torch.where(active, force_mag * BEAM_STRESS_SCALE,
                                   state.beam_stress),
        "beam_strain": torch.where(active,
                                   strain.abs() / state.beam_yield_strain,
                                   state.beam_strain),
        "beam_alive": state.beam_alive & ~(active & breaks),
    }
    force_vec = torch.where(active[:, None], force_vec, 0.0)
    return force_vec, upd, active & breaks


def accumulate_forces(state: SimState, force_vec: torch.Tensor,
                      cfg: StaticConfig) -> torch.Tensor:
    """Beam endpoint forces summed per particle ``[N, 2]``.

    ``force_mode="quantized"``: each contribution truncated to int32 at
    scale 65536 (WGSL ``i32()``, compute.wgsl:127-130) and summed in
    int32, so the total is exact in any order.  Through the state's CSR
    incidence when it has one (a gather), else ``index_add_`` (on CUDA
    the f32 segment sums have no fixed order)."""
    n = state.max_particles
    dev = force_vec.device
    if cfg.force_mode == "quantized":
        q = f32_to_i32(torch.trunc(force_vec * PARTICLE_FORCE_SCALE))
        if state.inc_beam is not None:
            contrib = q[state.inc_beam] * state.inc_sign[..., None].to(
                torch.int32)
            total = contrib.sum(dim=1, dtype=torch.int32)
        else:
            total = torch.zeros((n, 2), dtype=torch.int32, device=dev)
            total.index_add_(0, torch.cat([state.beam_a, state.beam_b]),
                             torch.cat([-q, q]))
        return total.to(torch.float32) / PARTICLE_FORCE_SCALE
    if state.inc_beam is not None:
        contrib = force_vec[state.inc_beam] * state.inc_sign[..., None].to(
            torch.float32)
        return contrib.sum(dim=1)
    total = torch.zeros((n, 2), dtype=torch.float32, device=dev)
    return total.index_add_(0, torch.cat([state.beam_a, state.beam_b]),
                            torch.cat([-force_vec, force_vec]))
