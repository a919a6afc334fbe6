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

from typing import NamedTuple

import torch

from ..config import BEAM_STRESS_SCALE, PARTICLE_FORCE_SCALE, StaticConfig
from ..state import SimState
from .stencil import f32_to_i32, sqrt32


class BeamTerms(NamedTuple):
    """What :func:`beam_terms` returns for a batch of beams."""

    fx: torch.Tensor        # force on endpoint b (a takes −F); not masked
    fy: torch.Tensor
    target: torch.Tensor    # the beam fields, updated where active
    last: torch.Tensor
    strain: torch.Tensor
    stress: torch.Tensor
    breaks: torch.Tensor    # active and past the strain limit


def beam_terms(dx, dy, active, *, target, last, length, spring, damp,
               yield_strain, strain_limit, strain, stress) -> BeamTerms:
    """The spring law (compute.wgsl:96-131) on any batch shape: the flat
    pass, the planified exception pass and the directed pass share it.
    ``(dx, dy)``: the a → b difference; ``active``: the beam and both
    its endpoints alive; the rest are the beam's fields."""
    raw_len = sqrt32(dx * dx + dy * dy)
    zero = raw_len == 0.0
    # compute.wgsl:104-107 — nudge to (0, -1e-10) to avoid 0/0
    dx = torch.where(zero, 0.0, dx)
    dy = torch.where(zero, -1.0e-10, dy)
    length_now = torch.where(zero, 1.0e-10, raw_len)

    force_mag = (target - length_now) * spring + (last - length_now) * damp
    inv_len = torch.reciprocal(length_now)

    stretch = (length_now - target) / length
    yielded = stretch.abs() > yield_strain
    new_target = torch.where(
        yielded, length_now - yield_strain * length * torch.sign(stretch),
        target)
    breaks = (length_now - length).abs() > length * strain_limit
    return BeamTerms(
        fx=(force_mag * dx) * inv_len,
        fy=(force_mag * dy) * inv_len,
        target=torch.where(active, new_target, target),
        last=torch.where(active, length_now, last),
        strain=torch.where(active, stretch.abs() / yield_strain, strain),
        stress=torch.where(active, force_mag * BEAM_STRESS_SCALE, stress),
        breaks=active & breaks)


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
    t = beam_terms(
        diff[:, 0], diff[:, 1], active,
        target=state.beam_target_length, last=state.beam_last_length,
        length=state.beam_length, spring=state.beam_spring,
        damp=state.beam_damp, yield_strain=state.beam_yield_strain,
        strain_limit=state.beam_strain_limit, strain=state.beam_strain,
        stress=state.beam_stress)
    upd = {
        "beam_target_length": t.target,
        "beam_last_length": t.last,
        "beam_stress": t.stress,
        "beam_strain": t.strain,
        "beam_alive": state.beam_alive & ~t.breaks,
    }
    force_vec = torch.where(active[:, None], torch.stack([t.fx, t.fy], -1),
                            0.0)
    return force_vec, upd, t.breaks


def endpoint_sums(n: int, a: torch.Tensor, b: torch.Tensor,
                  force_vec: torch.Tensor, quantized: bool) -> torch.Tensor:
    """``[n, 2]`` sums of ``−force_vec`` at ``a`` and ``+force_vec`` at
    ``b`` through one ``index_add_``.  ``quantized``: each contribution
    truncated to int32 at scale 65536 (WGSL ``i32()``,
    compute.wgsl:127-130) and the sum left in int32, exact in any order;
    else float32 (on CUDA in no fixed order)."""
    if quantized:
        force_vec = f32_to_i32(torch.trunc(force_vec * PARTICLE_FORCE_SCALE))
    total = torch.zeros((n, 2), dtype=force_vec.dtype,
                        device=force_vec.device)
    return total.index_add_(0, torch.cat([a, b]),
                            torch.cat([-force_vec, force_vec]))


def accumulate_forces(state: SimState, force_vec: torch.Tensor,
                      cfg: StaticConfig) -> torch.Tensor:
    """Beam endpoint forces summed per particle ``[N, 2]``.

    ``force_mode="quantized"``: each contribution truncated to int32 at
    scale 65536 and summed in int32, so the total is exact in any order.
    Through the state's CSR incidence when it has one (a gather), else
    :func:`endpoint_sums`."""
    quantized = cfg.force_mode == "quantized"
    if state.inc_beam is None:
        total = endpoint_sums(state.max_particles, state.beam_a,
                              state.beam_b, force_vec, quantized)
    else:
        fv = (f32_to_i32(torch.trunc(force_vec * PARTICLE_FORCE_SCALE))
              if quantized else force_vec)
        contrib = fv[state.inc_beam] * state.inc_sign[..., None].to(fv.dtype)
        total = contrib.sum(dim=1, dtype=fv.dtype)
    return total.to(torch.float32) / PARTICLE_FORCE_SCALE if quantized \
        else total
