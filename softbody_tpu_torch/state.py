"""General (gather-engine) simulation state: the port of
``softbody_tpu/state.py``.

A world is flat arrays padded to static capacities: particles ``[N, 2]``
float32 (position, velocity, acceleration) with alive and pinned masks,
and beams ``[M]`` (int endpoint indices, float32 parameters, the
strain/stress observability channels, an alive mask).  Broken beams and
deleted particles stay in place with their masks cleared.  An optional
CSR-style incidence ``inc_beam``/``inc_sign`` ``[N, D]``
(``ops/incidence.py``) lets the force pass gather instead of scatter.

Indices are int64 tensors (torch's indexing type); the JAX package
stores int32, and the values are the same.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .config import resolve_device
from .ops.incidence import build_incidence as _build_incidence

BEAM_FIELDS = ("beam_a", "beam_b", "beam_length", "beam_target_length",
               "beam_last_length", "beam_spring", "beam_damp",
               "beam_yield_strain", "beam_strain_limit", "beam_strain",
               "beam_stress", "beam_alive")
PARTICLE_FIELDS = ("pos", "vel", "acc", "particle_alive", "particle_pinned")


@dataclasses.dataclass
class SimState:
    """Softbody world state; ``particle_alive`` / ``beam_alive`` mark the
    live particles and beams (holes are allowed)."""

    pos: torch.Tensor
    vel: torch.Tensor
    acc: torch.Tensor
    particle_alive: torch.Tensor
    particle_pinned: torch.Tensor

    beam_a: torch.Tensor
    beam_b: torch.Tensor
    beam_length: torch.Tensor
    beam_target_length: torch.Tensor
    beam_last_length: torch.Tensor
    beam_spring: torch.Tensor
    beam_damp: torch.Tensor
    beam_yield_strain: torch.Tensor
    beam_strain_limit: torch.Tensor
    beam_strain: torch.Tensor
    beam_stress: torch.Tensor
    beam_alive: torch.Tensor

    inc_beam: Optional[torch.Tensor] = None
    inc_sign: Optional[torch.Tensor] = None

    @property
    def max_particles(self) -> int:
        return self.pos.shape[0]

    @property
    def max_beams(self) -> int:
        return self.beam_a.shape[0]

    @property
    def particle_count(self) -> torch.Tensor:
        """Live particle count (0-d tensor on the state's device)."""
        return self.particle_alive.sum()

    @property
    def beam_count(self) -> torch.Tensor:
        return self.beam_alive.sum()


def empty_state(max_particles: int, max_beams: int,
                device=None) -> SimState:
    """A zeroed world with the given capacities on ``device`` (default:
    the CUDA device; ``config.resolve_device``)."""
    device = resolve_device(device)
    n, m = int(max_particles), int(max_beams)

    def f32(shape, fill=0.0):
        return torch.full(shape, fill, dtype=torch.float32, device=device)

    def b(shape):
        return torch.zeros(shape, dtype=torch.bool, device=device)

    idx = torch.zeros((m,), dtype=torch.int64, device=device)
    return SimState(
        pos=f32((n, 2)), vel=f32((n, 2)), acc=f32((n, 2)),
        particle_alive=b((n,)), particle_pinned=b((n,)),
        beam_a=idx, beam_b=idx.clone(),
        beam_length=f32((m,), 1.0), beam_target_length=f32((m,), 1.0),
        beam_last_length=f32((m,), 1.0), beam_spring=f32((m,)),
        beam_damp=f32((m,)), beam_yield_strain=f32((m,), 1.0),
        beam_strain_limit=f32((m,), 1.0), beam_strain=f32((m,)),
        beam_stress=f32((m,)), beam_alive=b((m,)),
    )


def state_from_numpy(
    pos: np.ndarray,
    vel: Optional[np.ndarray] = None,
    *,
    beams: Optional[np.ndarray] = None,
    beam_length: Optional[np.ndarray] = None,
    beam_spring: Optional[np.ndarray] = None,
    beam_damp: Optional[np.ndarray] = None,
    beam_yield_strain: Optional[np.ndarray] = None,
    beam_strain_limit: Optional[np.ndarray] = None,
    beam_target_length: Optional[np.ndarray] = None,
    beam_last_length: Optional[np.ndarray] = None,
    acc: Optional[np.ndarray] = None,
    pinned: Optional[np.ndarray] = None,
    max_particles: Optional[int] = None,
    max_beams: Optional[int] = None,
    build_incidence: bool = True,
    device=None,
) -> SimState:
    """A :class:`SimState` on ``device`` (default: the CUDA device) from
    host arrays, with the JAX ``state_from_numpy``'s defaults: ``beams``
    ``[M, 2]`` endpoint indices, beam ``length`` the rest distance of the
    endpoints, spring 1, damp 0, yield and strain limit ∞, capacities the
    live counts (at least 1).  The incidence is built on the host from
    the endpoint arrays when there are beams and ``build_incidence``."""
    device = resolve_device(device)
    pos = np.asarray(pos, np.float32)
    n_live = pos.shape[0]
    vel = np.zeros_like(pos) if vel is None else np.asarray(vel, np.float32)
    acc = np.zeros_like(pos) if acc is None else np.asarray(acc, np.float32)
    pinned = (np.zeros((n_live,), bool) if pinned is None
              else np.asarray(pinned, bool))
    if beams is None:
        beams = np.zeros((0, 2), np.int32)
    beams = np.asarray(beams, np.int32).reshape(-1, 2)
    m_live = beams.shape[0]

    if beam_length is None:
        if m_live:
            d = pos[beams[:, 0]] - pos[beams[:, 1]]
            beam_length = np.sqrt((d * d).sum(-1), dtype=np.float32)
        else:
            beam_length = np.zeros((0,), np.float32)
    beam_length = np.asarray(beam_length, np.float32)

    def fill(x, default):
        if x is None:
            return np.full((m_live,), default, np.float32)
        return np.broadcast_to(np.asarray(x, np.float32), (m_live,)).copy()

    beam_spring = fill(beam_spring, 1.0)
    beam_damp = fill(beam_damp, 0.0)
    beam_yield_strain = fill(beam_yield_strain, np.inf)
    beam_strain_limit = fill(beam_strain_limit, np.inf)
    beam_target_length = (beam_length.copy() if beam_target_length is None
                          else np.asarray(beam_target_length, np.float32))
    beam_last_length = (beam_length.copy() if beam_last_length is None
                        else np.asarray(beam_last_length, np.float32))

    n = int(max_particles) if max_particles is not None else n_live
    m = int(max_beams) if max_beams is not None else max(m_live, 1)
    if n < n_live or m < m_live:
        raise ValueError("capacity smaller than live count")
    n = max(n, 1)
    m = max(m, 1)

    def padp(x):
        out = np.zeros((n,) + x.shape[1:], x.dtype)
        out[:n_live] = x
        return torch.from_numpy(out).to(device)

    def padb(x, fill_value=0, dtype=None):
        out = np.full((m,) + x.shape[1:], fill_value,
                      x.dtype if dtype is None else dtype)
        out[:m_live] = x
        return torch.from_numpy(out).to(device)

    state = SimState(
        pos=padp(pos), vel=padp(vel), acc=padp(acc),
        particle_alive=padp(np.ones((n_live,), bool)),
        particle_pinned=padp(pinned),
        beam_a=padb(beams[:, 0], dtype=np.int64),
        beam_b=padb(beams[:, 1], dtype=np.int64),
        beam_length=padb(beam_length, 1.0),
        beam_target_length=padb(beam_target_length, 1.0),
        beam_last_length=padb(beam_last_length, 1.0),
        beam_spring=padb(beam_spring),
        beam_damp=padb(beam_damp),
        beam_yield_strain=padb(beam_yield_strain, 1.0),
        beam_strain_limit=padb(beam_strain_limit, 1.0),
        beam_strain=padb(np.zeros((m_live,), np.float32)),
        beam_stress=padb(np.zeros((m_live,), np.float32)),
        beam_alive=padb(np.ones((m_live,), bool)),
    )
    if build_incidence and m_live:
        inc_beam, inc_sign = _build_incidence(beams[:, 0], beams[:, 1], n)
        state.inc_beam = torch.from_numpy(inc_beam.astype(np.int64)).to(
            device)
        state.inc_sign = torch.from_numpy(inc_sign).to(device)
    return state
