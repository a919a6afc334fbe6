"""Dense-lattice scene builders (port of
``softbody_tpu/models/lattice_dense.py``).  Each scene is built in numpy
and moved to ``device`` once: the CUDA device unless the caller names
another (``config.resolve_device``; it raises without a card).

The ``[W, H]`` layout flattens to linear index ``x*H + y``, the particle
order of the reference's ``addRectangle`` (main.ts:203-213);
:func:`lattice_to_simstate` flattens a lattice to the general
:class:`SimState` in that order."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import PhysicsConstants, StaticConfig
from ..convert import lattice_state_from_numpy
from ..ops.stencil import EDGE_OFFSETS, LatticeSpec, LatticeState
from ..state import SimState, state_from_numpy


def _lattice_numpy(w, h, spacing, ox, oy, spring, damp, yield_strain,
                   strain_limit, diagonals, pinned_mask) -> dict:
    xs = np.arange(w, dtype=np.float32) * spacing + ox
    ys = np.arange(h, dtype=np.float32) * spacing + oy
    pos = np.stack(np.meshgrid(xs, ys, indexing="ij"), axis=-1)
    f32 = np.float32
    x = np.arange(w)[:, None]
    y = np.arange(h)[None, :]
    edges = []
    for dx, dy in EDGE_OFFSETS:
        active = diagonals or (dx, dy) in ((0, 1), (1, 0))
        rest = f32(spacing * math.hypot(dx, dy))
        length = np.full((w, h), rest, f32)
        valid = ((x + dx >= 0) & (x + dx < w) & (y + dy >= 0)
                 & (y + dy < h)) & active
        edges.append(dict(
            length=length,
            target_length=length.copy(),
            last_length=length.copy(),
            spring=np.full((w, h), spring, f32),
            damp=np.full((w, h), damp, f32),
            yield_strain=np.full((w, h), yield_strain, f32),
            strain_limit=np.full((w, h), strain_limit, f32),
            strain=np.zeros((w, h), f32),
            stress=np.zeros((w, h), f32),
            alive=np.broadcast_to(valid, (w, h)).copy(),
        ))
    pinned = (np.zeros((w, h), bool) if pinned_mask is None
              else np.asarray(pinned_mask, bool))
    return dict(pos=pos, vel=np.zeros((w, h, 2), f32),
                acc=np.zeros((w, h, 2), f32), alive=np.ones((w, h), bool),
                pinned=pinned, edges=edges)


def _to_state(arrays: dict, device) -> LatticeState:
    return lattice_state_from_numpy(**arrays, device=device)


def make_lattice(
    w: int,
    h: int,
    spacing: float,
    *,
    ox: float = 10.0,
    oy: float = 10.0,
    spring: float = 120.0,
    damp: float = 10.0,
    yield_strain: float = 0.2,
    strain_limit: float = 0.25,
    diagonals: bool = True,
    pinned_mask: Optional[np.ndarray] = None,
    device=None,
) -> LatticeState:
    """A ``w × h`` lattice at ``spacing`` with the four reference edge
    classes (border edges statically dead)."""
    return _to_state(
        _lattice_numpy(w, h, spacing, ox, oy, spring, damp, yield_strain,
                       strain_limit, diagonals, pinned_mask),
        device)


def tearing_cloth_lattice(
    n_particles: int = 1_000_000,
    spring: float = 200.0,
    damp: float = 10.0,
    strain_limit: float = 0.5,
    yield_strain: float = 0.3,
    collision_stencil: int = 2,
    pin_top: bool = False,
    fall_speed: float = 2.0,
    slits: int = 0,
    device=None,
) -> Tuple[LatticeState, LatticeSpec, StaticConfig, PhysicsConstants]:
    """BASELINE config 5 on the dense path: a near-square lattice spanning
    the world, falling and tearing where it crumples on impact.

    ``slits > 0`` pre-perforates the sheet with that many vertical cuts,
    alternating from the bottom and top edges over 85% of the height, so
    tearing starts at the slit tips under gentle dynamics.  Gravity is
    scaled with the spacing (the default world gravity would crush a
    1000-row pile statically).  Returns ``(state, spec, cfg, consts)``."""
    side = int(math.sqrt(n_particles))
    w = h = side
    spacing = 980.0 / (side - 1)
    pinned = np.zeros((w, h), bool)
    if pin_top:
        pinned[:, h - 1] = True
    arrays = _lattice_numpy(w, h, spacing, 10.0, 10.0, spring, damp,
                            yield_strain, strain_limit, True, pinned)
    for si in range(slits):
        cx = (si + 1) * w // (slits + 1)  # cut between columns cx, cx+1
        lo, hi = (0, int(0.85 * h)) if si % 2 == 0 else (int(0.15 * h), h)
        for ci, (dx, _dy) in enumerate(EDGE_OFFSETS):
            if dx != 0:  # vertical edges don't cross a vertical cut
                arrays["edges"][ci]["alive"][cx, lo:hi] = False
    if not pin_top and fall_speed:
        arrays["vel"][..., 1] = -fall_speed
    spec = LatticeSpec(w, h, collision_stencil=collision_stencil)
    cfg = StaticConfig(
        subticks=64,
        collision_mode="allpairs",
        # contact radius 0.35x spacing: ~30% compression headroom before
        # the stiff dt^-2 penetration term engages
        particle_radius=spacing * 0.35,
    )
    consts = PhysicsConstants(gravity=(0.0, -0.5 * spacing / 10.0))
    return _to_state(arrays, device), spec, cfg, consts


def cloth_lattice(
    w: int = 32,
    h: int = 32,
    spacing: float = 20.0,
    spring: float = 50.0,
    damp: float = 10.0,
    pin_top: bool = False,
    collision_stencil: int = 2,
    device=None,
) -> Tuple[LatticeState, LatticeSpec, StaticConfig]:
    """A cloth hanging near the top of the world."""
    ox = 500.0 - (w - 1) * spacing / 2
    oy = 980.0 - (h - 1) * spacing
    pinned = np.zeros((w, h), bool)
    if pin_top:
        pinned[:, h - 1] = True
    state = make_lattice(
        w, h, spacing, ox=ox, oy=oy, spring=spring, damp=damp,
        yield_strain=1.0, strain_limit=2.5, pinned_mask=pinned,
        device=device,
    )
    spec = LatticeSpec(w, h, collision_stencil=collision_stencil)
    cfg = StaticConfig(
        subticks=64, collision_mode="allpairs",
        particle_radius=min(10.0, spacing * 0.45),
    )
    return state, spec, cfg


def lattice_to_simstate(state: LatticeState, *, build_incidence: bool = True,
                        device=None) -> SimState:
    """Flatten to the general SimState (linear index = x*H + y) on
    ``device`` (default: the CUDA device), in NumPy on the host over the
    state's planes, as the JAX package does."""
    def host(t):
        return t.detach().cpu().numpy()

    w, h = state.shape
    n = w * h
    pos = host(state.pos).reshape(n, 2)
    vel = host(state.vel).reshape(n, 2)
    acc = host(state.acc).reshape(n, 2)
    pinned = host(state.pinned).reshape(n)
    alive = host(state.alive).reshape(n)

    beams = []
    props = {k: [] for k in ("length", "target", "last", "spring", "damp",
                             "yield", "limit", "strain", "stress")}
    x = np.arange(w)[:, None]
    y = np.arange(h)[None, :]
    lin = (x * h + y)
    for (dx, dy), e in zip(EDGE_OFFSETS, state.edges):
        valid = host(e.alive) & (
            (x + dx >= 0) & (x + dx < w) & (y + dy >= 0) & (y + dy < h)
        )
        idx = np.nonzero(valid.reshape(n))
        a = lin.reshape(n)[idx]
        b = a + dx * h + dy
        beams.append(np.stack([a, b], -1))
        for key, arr in (
            ("length", e.length), ("target", e.target_length),
            ("last", e.last_length), ("spring", e.spring), ("damp", e.damp),
            ("yield", e.yield_strain), ("limit", e.strain_limit),
            ("strain", e.strain), ("stress", e.stress),
        ):
            props[key].append(host(arr)[valid])

    beams_np = (
        np.concatenate(beams).astype(np.int32)
        if beams else np.zeros((0, 2), np.int32)
    )

    def cat(k):
        return (
            np.concatenate(props[k]).astype(np.float32)
            if props[k] else np.zeros((0,), np.float32)
        )

    sim = state_from_numpy(
        pos, vel, acc=acc, pinned=pinned,
        beams=beams_np if len(beams_np) else None,
        beam_length=cat("length"),
        beam_spring=cat("spring"), beam_damp=cat("damp"),
        beam_yield_strain=cat("yield"), beam_strain_limit=cat("limit"),
        beam_target_length=cat("target"), beam_last_length=cat("last"),
        build_incidence=build_incidence, device=device,
    )
    if len(beams_np):
        m = sim.max_beams
        strain = np.zeros(m, np.float32)
        stress = np.zeros(m, np.float32)
        strain[: len(beams_np)] = cat("strain")
        stress[: len(beams_np)] = cat("stress")
        sim.beam_strain = torch.from_numpy(strain).to(sim.pos.device)
        sim.beam_stress = torch.from_numpy(stress).to(sim.pos.device)
    if not alive.all():
        sim.particle_alive = torch.from_numpy(alive).to(sim.pos.device)
    return sim
