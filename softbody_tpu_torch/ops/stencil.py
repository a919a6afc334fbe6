"""Dense lattice (stencil) physics as plain torch ops: the port of
``softbody_tpu/ops/stencil.py``.

A lattice world lives on ``[W, H]`` planes.  Its beams connect constant
index offsets (one edge class per offset: the four of ``EDGE_OFFSETS``
for lattice scenes, any set for the planified path, ``ops/planify.py``),
so every physics term is a shifted stencil: springs evaluate each edge
once at its lower endpoint and apply the reaction shifted to the
partner; collisions evaluate each unordered
index pair within Chebyshev radius ``s`` once (half offsets) and apply
the exact negation to the partner (compute.wgsl:150-168 pair math).

These functions are also the plain versions of the fused substep kernel
(``ops/cuda/fused_substep2.py``): the kernel evaluates the same float32
expressions in the same order, with no fused multiply-add, so its
integer spring sums and edge planes match bit for bit.

Out-of-range neighbours read as dead particles at the origin (the JAX
package's zero pad).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import (
    BEAM_STRESS_SCALE,
    PARTICLE_FORCE_SCALE,
    PhysicsConstants,
    StaticConfig,
    UserInput,
    consts_vector,
)


@dataclasses.dataclass
class EdgeClass:
    """Per-edge-class state ``[W, H]``, stored at the lower-index endpoint
    (the edge at (x, y) connects to (x+dx, y+dy)).  Field meanings match
    the 40-byte beam record (engineMapping.ts:151)."""

    length: torch.Tensor
    target_length: torch.Tensor
    last_length: torch.Tensor
    spring: torch.Tensor
    damp: torch.Tensor
    yield_strain: torch.Tensor
    strain_limit: torch.Tensor
    strain: torch.Tensor
    stress: torch.Tensor
    alive: torch.Tensor


@dataclasses.dataclass
class LatticeState:
    """Dense lattice world: particle grids ``[W, H(, 2)]`` + edge classes."""

    pos: torch.Tensor
    vel: torch.Tensor
    acc: torch.Tensor
    alive: torch.Tensor
    pinned: torch.Tensor
    edges: Tuple[EdgeClass, ...]

    @property
    def shape(self) -> Tuple[int, int]:
        return self.pos.shape[0], self.pos.shape[1]

    @property
    def device(self) -> torch.device:
        return self.pos.device


# Edge-class offsets matching addRectangle (main.ts:208-211).
EDGE_OFFSETS: Tuple[Tuple[int, int], ...] = ((0, 1), (1, 0), (1, 1), (1, -1))


@dataclasses.dataclass(frozen=True)
class LatticeSpec:
    """Static lattice configuration."""

    width: int
    height: int
    # index-space Chebyshev radius of the dense collision stencil
    collision_stencil: int = 2
    edge_offsets: Tuple[Tuple[int, int], ...] = EDGE_OFFSETS

    @property
    def collision_half_offsets(self) -> Tuple[Tuple[int, int], ...]:
        """Half-plane offsets: each unordered pair once."""
        return half_offsets(self.collision_stencil)


def check_reference_offsets(spec: LatticeSpec) -> None:
    """The fused kernels (K1, K4) evaluate the four classes of
    ``EDGE_OFFSETS`` only: raise for a spec with any other offsets."""
    if tuple(spec.edge_offsets) != EDGE_OFFSETS:
        raise ValueError(f"the fused kernels take the edge offsets "
                         f"{EDGE_OFFSETS} only, got {spec.edge_offsets}")


def half_offsets(s: int) -> Tuple[Tuple[int, int], ...]:
    """Collision half offsets of radius ``s``, in summation order."""
    return tuple(
        (dx, dy)
        for dx in range(0, s + 1)
        for dy in range(-s, s + 1)
        if (dx, dy) != (0, 0) and (dx > 0 or dy > 0)
    )


class Scalars(NamedTuple):
    """The consts vector (``config.consts_vector``) as host floats."""

    radius: float
    dt: float
    bounds: float
    gx: float
    gy: float
    border_elasticity: float
    border_friction: float
    ecoeff: float
    friction: float
    drag_coeff: float
    drag_exp: float
    user_strength: float
    mouse_active: float
    mouse_px: float
    mouse_py: float
    mouse_vx: float
    mouse_vy: float
    force_x: float
    force_y: float
    world_h: float

    @classmethod
    def of(cls, cvec: torch.Tensor) -> "Scalars":
        return cls(*cvec[: len(cls._fields)].tolist())


def _mul32(a: float, b: float) -> float:
    """float32 product of two float32 host scalars."""
    return float(np.float32(a) * np.float32(b))


def _add32(a: float, b: float) -> float:
    return float(np.float32(a) + np.float32(b))


def _sub32(a: float, b: float) -> float:
    return float(np.float32(a) - np.float32(b))


def device_scalar(x: float, device) -> torch.Tensor:
    """A 0-d float32 tensor on ``device``.  Divide by this, not by a host
    scalar: on CUDA, torch turns ``t / host_scalar`` into a multiply by
    the reciprocal, which is not the division the kernels evaluate.
    Filled on the device (``torch.full``), not copied from the host: a
    blocking host-to-device copy would wait for the stream to drain."""
    return torch.full((), x, dtype=torch.float32, device=device)


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (as XLA's and the kernels').
    torch's CPU ``sqrt`` is not: it misses the IEEE result for a few
    float32 inputs in a thousand.  Through float64 it is exact."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def index_sum(index: torch.Tensor, src: torch.Tensor, n: int,
              keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[n, k]`` rows: row ``i`` is the sum of the rows of ``src [N, k]``
    whose ``index`` is ``i``, added one by one in ascending source order
    starting from +0.0 — what the CPU's sequential ``index_add_`` on
    zeros computes, so the card reproduces the CPU bit for bit and run to
    run.  On CUDA, ``index_add_`` sums with atomics in no fixed order;
    ``index_put_(accumulate=True)`` sorts the indices stably and sums
    each index's run in order from zero, one thread per run.  It does
    that for rows of two or more values only (rows of one are summed as
    a warp tree), so such rows are refused there.  On the CPU,
    ``index_put_`` is the one that runs threads in no fixed order, so the
    CPU keeps ``index_add_``.

    ``keep`` ``[N]`` bool: rows where it is false are left out of the
    sums, each sent to a spare row of its own past ``n`` (the shapes stay
    fixed and no host read is needed).  Leaving out rows of ±0.0 changes
    no sum: a sum started from +0.0 is never -0.0, and x ± 0.0 = x.  The
    far apply leaves out its empty list slots this way: they all name one
    chunk, whose run would otherwise be summed by one thread."""
    if keep is not None:
        spare = torch.arange(n, n + index.shape[0], device=index.device)
        return index_sum(torch.where(keep, index, spare), src,
                         n + index.shape[0])[:n]
    out = src.new_zeros((n,) + tuple(src.shape[1:]))
    if src.device.type == "cpu":
        return out.index_add_(0, index, src)
    if src.dim() != 2 or src.shape[1] < 2:
        raise ValueError(f"index_sum sums rows of >= 2 values in a fixed "
                         f"order on CUDA, got {tuple(src.shape)}")
    return out.index_put_((index,), src, accumulate=True)


def shifted(a: torch.Tensor, dx: int, dy: int, fill=0) -> torch.Tensor:
    """``out[..., x, y] = a[..., x + dx, y + dy]``; ``fill`` outside."""
    w, h = a.shape[-2], a.shape[-1]
    out = torch.full_like(a, fill)
    x0, x1 = max(0, -dx), min(w, w - dx)
    y0, y1 = max(0, -dy), min(h, h - dy)
    if x0 < x1 and y0 < y1:
        out[..., x0:x1, y0:y1] = a[..., x0 + dx : x1 + dx, y0 + dy : y1 + dy]
    return out


def back(a: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """``out[x + dx, y + dy] = a[x, y]`` (zero fill): place an edge term
    at the partner endpoint."""
    return shifted(a, -dx, -dy, 0)


def f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """float32 → int32 the way XLA and CUDA's ``cvt.rzi.sat`` convert an
    already-truncated value: saturating at the int32 range, NaN → 0
    (a bare ``.to(torch.int32)`` is undefined out of range)."""
    x = torch.nan_to_num(x, nan=0.0, posinf=3.0e9, neginf=-3.0e9)
    top = x >= 2147483648.0
    v = x.clamp(-2147483648.0, 2147483520.0).to(torch.int32)
    return torch.where(top, torch.full_like(v, 2147483647), v)


class SpringUpdate(NamedTuple):
    target: torch.Tensor
    last: torch.Tensor
    alive: torch.Tensor      # bool
    active: torch.Tensor     # bool: the edge took part in this substep
    strain: torch.Tensor     # |strain| / yield (observability)
    stress: torch.Tensor     # force_mag · BEAM_STRESS_SCALE (observability)


def spring_pass(px, py, alive, edges: Sequence, quantized: bool,
                offsets: Sequence[Tuple[int, int]] = EDGE_OFFSETS,
                extra_force=None):
    """Spring forces of the edge classes (class ``c`` at ``offsets[c]``,
    evaluated in that order) and the edge-state updates.

    ``edges[c]`` has the :class:`EdgeClass` attributes ``length``,
    ``target_length``, ``last_length``, ``spring``, ``damp``,
    ``yield_strain``, ``strain_limit`` (planes or 0-d float32 tensors)
    and ``alive`` (bool plane).  ``extra_force``: ``(fx, fy)`` planes
    added to the accumulator before the classes (int32 at scale 65536
    when quantized, else float32: the planified path's exception beams).
    Returns ``(bfx, bfy, updates)``.  Quantized forces accumulate
    ``trunc(F·65536)`` in int32, so the sum is exact whatever the order
    (compute.wgsl:127-130)."""
    w, h = px.shape
    acc_t = torch.int32 if quantized else torch.float32
    fx = torch.zeros((w, h), dtype=acc_t, device=px.device)
    fy = torch.zeros((w, h), dtype=acc_t, device=px.device)
    if extra_force is not None:
        fx = fx + extra_force[0]
        fy = fy + extra_force[1]
    updates: List[SpringUpdate] = []
    for (dx, dy), e in zip(offsets, edges):
        active = e.alive & alive & shifted(alive, dx, dy, False)
        ddx = shifted(px, dx, dy) - px
        ddy = shifted(py, dx, dy) - py
        raw_len = sqrt32(ddx * ddx + ddy * ddy)
        zero = raw_len == 0.0
        # zero-length guard (compute.wgsl:104-107): diff → (0, -1e-10)
        ddx = torch.where(zero, 0.0, ddx)
        ddy = torch.where(zero, -1.0e-10, ddy)
        ln = torch.where(zero, 1.0e-10, raw_len)

        fmag = (e.target_length - ln) * e.spring + (e.last_length - ln) * e.damp
        inv_len = torch.reciprocal(ln)
        fvx = fmag * ddx * inv_len
        fvy = fmag * ddy * inv_len
        strain = (ln - e.target_length) / e.length
        yielded = strain.abs() > e.yield_strain
        new_target = torch.where(
            yielded,
            ln - e.yield_strain * e.length * torch.sign(strain),
            e.target_length,
        )
        breaks = (ln - e.length).abs() > e.length * e.strain_limit
        updates.append(SpringUpdate(
            target=torch.where(active, new_target, e.target_length),
            last=torch.where(active, ln, e.last_length),
            alive=e.alive & ~(active & breaks),
            active=active,
            strain=strain.abs() / e.yield_strain,
            stress=fmag * BEAM_STRESS_SCALE,
        ))

        fvx = torch.where(active, fvx, 0.0)
        fvy = torch.where(active, fvy, 0.0)
        if quantized:
            qx = f32_to_i32(torch.trunc(fvx * PARTICLE_FORCE_SCALE))
            qy = f32_to_i32(torch.trunc(fvy * PARTICLE_FORCE_SCALE))
            fx = fx - qx + back(qx, dx, dy)
            fy = fy - qy + back(qy, dx, dy)
        else:
            fx = fx - fvx + back(fvx, dx, dy)
            fy = fy - fvy + back(fvy, dx, dy)

    if quantized:
        fx = fx.to(torch.float32) / PARTICLE_FORCE_SCALE
        fy = fy.to(torch.float32) / PARTICLE_FORCE_SCALE
    return fx, fy, updates


def _stencil_collisions(px, py, vx, vy, alive, *, s: int, radius: float,
                        dt: float, ecoeff: float, friction: float):
    """Reference pair math over the half-offset stencil of radius ``s``.

    Each unordered pair is evaluated once at its lower endpoint and its
    exact negation applied to the partner, per offset in the order of
    :func:`half_offsets`: ``acc = (acc + t) - back(t)``.  The coincident
    nudge ``sign(lin_i − lin_j)`` is the per-offset constant
    ``−sign(dx·H + dy)``.  Returns (dvx, dvy, dax, day, dyn)."""
    w, h = px.shape
    two_r = _mul32(2.0, radius)
    dt2 = device_scalar(_mul32(dt, dt), px.device)
    z = torch.zeros_like(px)
    dvx, dvy, dax, day, dyn = z, z, z, z, z
    for ox, oy in half_offsets(s):
        valid = alive & shifted(alive, ox, oy, False)
        ddx = shifted(px, ox, oy) - px
        ddy = shifted(py, ox, oy) - py
        dist = sqrt32(ddx * ddx + ddy * ddy)
        coincident = valid & (dist == 0.0)
        overlap = valid & (dist > 0.0) & (dist < two_r)

        co = torch.where(coincident, -float(np.sign(ox * h + oy)), 0.0)
        dyn = dyn + co - back(co, ox, oy)

        inv = torch.where(
            overlap, torch.reciprocal(torch.where(overlap, dist, 1.0)), 0.0
        )
        nx, ny = ddx * inv, ddy * inv
        rvx = vx - shifted(vx, ox, oy)
        rvy = vy - shifted(vy, ox, oy)
        imp_n = ecoeff * (rvx * nx + rvy * ny)
        max_fric = imp_n * friction
        imp_t = torch.minimum(
            torch.maximum(rvx * -ny + rvy * nx, -max_fric), max_fric
        )
        pdvx = -(imp_n * nx + imp_t * -ny)
        pdvy = -(imp_n * ny + imp_t * nx)
        clip = (two_r - dist) * 0.5 / dt2
        gate = overlap.to(torch.float32)
        pdax = -nx * clip * gate
        pday = -ny * clip * gate
        pdvx = torch.where(overlap, pdvx, 0.0)
        pdvy = torch.where(overlap, pdvy, 0.0)

        dvx = dvx + pdvx - back(pdvx, ox, oy)
        dvy = dvy + pdvy - back(pdvy, ox, oy)
        dax = dax + pdax - back(pdax, ox, oy)
        day = day + pday - back(pday, ox, oy)
    return dvx, dvy, dax, day, dyn


def _integrate_components(px, py, vx, vy, ax, ay, alive, pinned,
                          dvx, dvy, dax, day, dyn, bfx, bfy, sc: Scalars):
    """Body forces, drag, user force, mouse grab, semi-implicit Euler and
    the border (compute.wgsl:171-199), on component planes."""
    r = sc.radius
    p_x = px
    p_y = py + torch.where(alive, dyn, 0.0)
    v_x = vx + dvx
    v_y = vy + dvy
    a_x = ax + dax + sc.gx
    a_y = ay + day + sc.gy

    speed = sqrt32(v_x * v_x + v_y * v_y)
    moving = speed > 0.0
    inv_speed = torch.reciprocal(torch.where(moving, speed, 1.0))
    a_x = a_x - torch.where(
        moving,
        sc.drag_coeff * torch.pow(v_x.abs(), sc.drag_exp) * v_x * inv_speed,
        0.0,
    )
    a_y = a_y - torch.where(
        moving,
        sc.drag_coeff * torch.pow(v_y.abs(), sc.drag_exp) * v_y * inv_speed,
        0.0,
    )

    a_x = a_x + _mul32(sc.force_x, sc.user_strength)
    a_y = a_y + _mul32(sc.force_y, sc.user_strength)

    mdx = sc.mouse_px - p_x
    mdy = sc.mouse_py - p_y
    grabbed = (sqrt32(mdx * mdx + mdy * mdy) < _mul32(r, 10.0)) & (
        sc.mouse_active > 0.0)
    a_x = a_x + torch.where(
        grabbed, (sc.mouse_vx - v_x) * sc.user_strength - sc.gx, 0.0)
    a_y = a_y + torch.where(
        grabbed, (sc.mouse_vy - v_y) * sc.user_strength - sc.gy, 0.0)

    a_x = a_x + bfx
    a_y = a_y + bfy

    v_x = v_x + a_x * sc.dt
    v_y = v_y + a_y * sc.dt
    p_x = p_x + v_x * sc.dt
    p_y = p_y + v_y * sc.dt

    lo, hi = r, _sub32(sc.bounds, r)
    cx_ = torch.clamp(p_x, lo, hi)
    cy_ = torch.clamp(p_y, lo, hi)
    hit_x = p_x != cx_
    hit_y = p_y != cy_
    be = sc.border_elasticity
    bf = sc.border_friction
    one_be = _add32(1.0, be)

    fric_y = torch.sign(v_y) * bf * v_x.abs() * one_be
    na_y = torch.where(hit_x, 0.0 - torch.clamp(fric_y, max=0.0), 0.0)
    nv_x = torch.where(hit_x, v_x * -be, v_x)
    fric_x = torch.sign(nv_x) * bf * v_y.abs() * one_be
    na_x = torch.where(hit_y, 0.0 - torch.clamp(fric_x, max=0.0), 0.0)
    nv_y = torch.where(hit_y, v_y * -be, v_y)

    keep = alive & ~pinned
    return (
        torch.where(keep, cx_, px),
        torch.where(keep, cy_, py),
        torch.where(keep, nv_x, vx),
        torch.where(keep, nv_y, vy),
        torch.where(keep, na_x, ax),
        torch.where(keep, na_y, ay),
    )


def substep_planes(px, py, vx, vy, ax, ay, alive, pinned, edges, sc: Scalars,
                   *, stencil: int, quantized: bool, far_deltas=(),
                   full_stencil: bool = False,
                   offsets: Sequence[Tuple[int, int]] = EDGE_OFFSETS,
                   extra_force=None):
    """One substep on component planes: springs (``spring_pass`` over
    ``offsets``, ``extra_force`` first), collisions, each of the
    ``far_deltas`` (``[5, W, H]`` stacks of dvx dvy dax day dyn, or
    None) in turn, integration.  ``full_stencil``: the collisions go
    through the K3 wrapper (``ops/cuda/collide_stencil.py``, full offset
    set) instead of the half-offset sum.  Returns the six new particle
    planes and the spring updates."""
    bfx, bfy, ups = spring_pass(px, py, alive, edges, quantized, offsets,
                                extra_force)
    kw = dict(radius=sc.radius, dt=sc.dt, ecoeff=sc.ecoeff,
              friction=sc.friction)
    if stencil == 0:
        z = torch.zeros_like(px)
        dvx = dvy = dax = day = dyn = z
    elif full_stencil:
        from .cuda.collide_stencil import collide_stencil_call

        dvx, dvy, dax, day, dyn = collide_stencil_call(
            px, py, vx, vy, alive, stencil=stencil, **kw)
    else:
        dvx, dvy, dax, day, dyn = _stencil_collisions(
            px, py, vx, vy, alive, s=stencil, **kw)
    for fd in far_deltas:
        if fd is None:
            continue
        dvx = dvx + fd[0]
        dvy = dvy + fd[1]
        dax = dax + fd[2]
        day = day + fd[3]
        dyn = dyn + fd[4]
    planes = _integrate_components(px, py, vx, vy, ax, ay, alive, pinned,
                                   dvx, dvy, dax, day, dyn, bfx, bfy, sc)
    return planes, ups


def lattice_substep(
    state: LatticeState,
    consts: PhysicsConstants,
    uin: UserInput,
    spec: LatticeSpec,
    cfg: StaticConfig,
    update_observability: bool = True,
    far_delta: Optional[torch.Tensor] = None,
    far=None,
    ffspec=None,
    extra_force=None,
    lin_x_offset=0,
) -> LatticeState:
    """One substep of the dense path (semantics of compute.wgsl:90-203).

    Edge class ``c`` connects the offset ``spec.edge_offsets[c]``.
    ``update_observability``: write per-edge strain/stress (only the
    frame's last substep needs them).  ``far_delta``: precomputed
    ``[5, W, H]`` far-field delta planes (dvx dvy dax day dyn) from the
    bucketed apply (``ops/farfield4.py``).  ``far``/``ffspec``: a
    candidate :class:`~.farfield.FarList` and its spec, whose pair terms
    (``farfield.far_collision_terms``) are added after ``far_delta``.
    ``extra_force``: ``(fx, fy)`` planes merged into the spring
    accumulator before the classes (``spring_pass``).
    ``cfg.use_pallas``: collisions through kernel K3.
    ``lin_x_offset``: the global x of column 0 of a column slab, accepted
    and ignored.  The coincident tiebreak ``sign(lin_i − lin_j)`` is the
    per-offset constant ``−sign(dx·H + dy)``, the same on any slab, so the
    JAX package's argument is vestigial there too
    (``softbody_tpu/parallel/lattice_spatial.py:66-71``)."""
    sc = Scalars.of(consts_vector(consts, uin, cfg, spec.height))
    collide = cfg.collision_mode != "none"
    px, py = state.pos[..., 0], state.pos[..., 1]
    vx, vy = state.vel[..., 0], state.vel[..., 1]
    far_terms = None
    if far is not None and collide:
        from .farfield import far_collision_terms

        far_terms = far_collision_terms(
            px, py, vx, vy, state.alive, far, s=spec.collision_stencil,
            ff=ffspec, radius=cfg.particle_radius, dt=cfg.dt,
            ecoeff=consts.ecoeff, friction=consts.friction,
            world_h=spec.height)
    (pxn, pyn, vxn, vyn, axn, ayn), ups = substep_planes(
        px, py, vx, vy, state.acc[..., 0], state.acc[..., 1],
        state.alive, state.pinned, state.edges, sc,
        stencil=spec.collision_stencil if collide else 0,
        quantized=cfg.force_mode == "quantized",
        far_deltas=(far_delta if collide else None, far_terms),
        full_stencil=cfg.use_pallas,
        offsets=spec.edge_offsets,
        extra_force=extra_force,
    )
    new_edges = []
    for e, u in zip(state.edges, ups):
        new_edges.append(dataclasses.replace(
            e,
            target_length=u.target,
            last_length=u.last,
            alive=u.alive,
            strain=(torch.where(u.active, u.strain, e.strain)
                    if update_observability else e.strain),
            stress=(torch.where(u.active, u.stress, e.stress)
                    if update_observability else e.stress),
        ))
    return dataclasses.replace(
        state,
        pos=torch.stack([pxn, pyn], dim=-1),
        vel=torch.stack([vxn, vyn], dim=-1),
        acc=torch.stack([axn, ayn], dim=-1),
        edges=tuple(new_edges),
    )


def lattice_frame(
    state: LatticeState,
    consts: PhysicsConstants,
    uin: UserInput,
    spec: LatticeSpec,
    cfg: StaticConfig,
    n_sub: Optional[int] = None,
) -> LatticeState:
    """``n_sub`` (default ``cfg.subticks``) observing substeps."""
    n = cfg.subticks if n_sub is None else n_sub
    for _ in range(n):
        state = lattice_substep(state, consts, uin, spec, cfg)
    return state


def lattice_frame_far(
    state: LatticeState,
    far,
    consts: PhysicsConstants,
    uin: UserInput,
    spec: LatticeSpec,
    cfg: StaticConfig,
    ffspec,
    n_sub: Optional[int] = None,
) -> LatticeState:
    """One frame with far-field contacts: the candidate list ``far`` is
    fixed for the whole frame (its validity is the caller's contract —
    ``LatticeBackend``'s rebuild trigger, which may run a frame as
    several shorter chunks through ``n_sub``)."""
    n = cfg.subticks if n_sub is None else n_sub
    for _ in range(n):
        state = lattice_substep(state, consts, uin, spec, cfg, far=far,
                                ffspec=ffspec)
    return state
