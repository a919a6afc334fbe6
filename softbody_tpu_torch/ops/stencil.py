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
integer spring sums and edge planes match bit for bit.  Two of the JAX
kernel's variants (``softbody_tpu/ops/pallas/fused_substep2.py``
``kvar``) change its arithmetic, and are flags here for that kernel
only: ``rsqrt`` (a reciprocal square root and products where strict
takes a square root and a divide; contact and grab tests on squared
distances) and ``rollgroup`` (the partners' reactions summed per Δy,
after the loop over classes or offsets).  Strict is the default.

Out-of-range neighbours read as dead particles at the origin (the JAX
package's zero pad).

``lattice_frame_jit``, ``lattice_frame_far_jit`` and
``lattice_substep_jit`` are the compiled counterparts of the JAX
package's jitted functions (``ops/compiled.py``): CUDA graphs on the
card, captured once per key (``n_sub`` and the far list's capacity among
it) and replayed, K3 launched inside them with ``cfg.use_pallas``; the
functions themselves on the CPU.
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
from . import compiled
from .compiled import Compiled


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
    """The consts vector (``config.consts_vector``) as 0-d float32 views
    of it, on its device: no host read, so a captured frame reads the
    values of each replay.  ``vec`` is the vector itself (the kernels
    read it in device memory)."""

    radius: torch.Tensor
    dt: torch.Tensor
    bounds: torch.Tensor
    gx: torch.Tensor
    gy: torch.Tensor
    border_elasticity: torch.Tensor
    border_friction: torch.Tensor
    ecoeff: torch.Tensor
    friction: torch.Tensor
    drag_coeff: torch.Tensor
    drag_exp: torch.Tensor
    user_strength: torch.Tensor
    mouse_active: torch.Tensor
    mouse_px: torch.Tensor
    mouse_py: torch.Tensor
    mouse_vx: torch.Tensor
    mouse_vy: torch.Tensor
    force_x: torch.Tensor
    force_y: torch.Tensor
    world_h: torch.Tensor
    vec: Optional[torch.Tensor] = None

    @classmethod
    def of(cls, cvec: torch.Tensor) -> "Scalars":
        n = len(cls._fields) - 1
        return cls(*cvec[:n].unbind(0), vec=cvec)


def _mul32(a: float, b: float) -> float:
    """float32 product of two float32 host scalars."""
    return float(np.float32(a) * np.float32(b))


def tpow(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """``torch.pow(x, e)`` for a 0-d tensor exponent with the fast paths
    ``torch.pow(tensor, scalar)`` takes for a host one (1, 2, 3, 0.5 and
    0: ``x``, ``x·x``, ``x·x·x``, ``sqrt``, 1), which ``pow(tensor,
    tensor)`` does not take: the bits of a host exponent, and K1/K4's
    ``tpow`` (``csrc/lattice_device.cuh``)."""
    out = torch.pow(x, e)
    for val, fast in ((0.0, lambda: torch.ones_like(x)),
                      (0.5, lambda: torch.sqrt(x)),
                      (3.0, lambda: x * x * x), (2.0, lambda: x * x),
                      (1.0, lambda: x)):
        out = torch.where(e == val, fast(), out)
    return out


class Decisions(NamedTuple):
    """The host decisions of a frame: what its constants allow, which
    picks a kernel instance (or refuses a variant) and so is part of a
    compiled frame's key (``compiled.Compiled(decide=)``).  ``k1_skip``,
    ``k4_skip``: K1's and K4's pair skip (``pair_skip_allowed`` in
    ``csrc/lattice_device.cuh``: K1 multiplies its clip by ``1/dt²``, K4
    divides); ``k3_skip``: K3's (``consts_allow_skip``,
    ``csrc/collide_stencil.cu``); ``drag_exp2``: the drag exponent is 2
    (the ``dexp2`` variant's condition)."""

    k1_skip: bool
    k4_skip: bool
    k3_skip: bool
    drag_exp2: bool


_F32_MAX = np.float32(3.402823466e38)


def _finite(*xs) -> bool:
    return all(abs(x) <= _F32_MAX for x in xs)


def _pair_skip_allowed(two_r, dt2, ecoeff, friction, inv_dt2: bool) -> bool:
    """``pair_skip_allowed`` of ``csrc/lattice_device.cuh``, in float32."""
    scale = np.float32(1.0) / dt2 if inv_dt2 else dt2
    sq = two_r * two_r * np.float32(1.00001)
    gap = (two_r - np.sqrt(_F32_MAX)) * np.float32(0.5)
    clip_far = gap * scale if inv_dt2 else gap / scale
    return (_finite(ecoeff, friction, two_r, scale, sq, clip_far)
            and sq >= np.float32(1.17549435e-38))


def host_decisions(radius: float, dt: float, ecoeff: float, friction: float,
                   drag_exp: float) -> Decisions:
    """:class:`Decisions` of host float32 values, as the kernels' host
    entries decide them."""
    with np.errstate(all="ignore"):
        r, t = np.float32(radius), np.float32(dt)
        e, f = np.float32(ecoeff), np.float32(friction)
        two_r = np.float32(2.0) * r
        dt2 = t * t
        inv_dt2 = np.float32(1.0) / dt2
        sq = two_r * two_r * np.float32(1.00001)
        clip_far = ((two_r - np.sqrt(_F32_MAX)) * np.float32(0.5)
                    * inv_dt2)
        k3 = (_finite(e, f, two_r, inv_dt2, sq, clip_far)
              and sq >= np.float32(1.17549435e-38))
        return Decisions(_pair_skip_allowed(two_r, dt2, e, f, True),
                         _pair_skip_allowed(two_r, dt2, e, f, False),
                         bool(k3), float(drag_exp) == 2.0)


def frame_decisions(arguments: dict) -> Decisions:
    """A compiled frame's ``decide`` (``compiled.Compiled``): the
    :class:`Decisions` of its host ``consts`` and static ``cfg``."""
    consts, cfg = arguments["consts"], arguments["cfg"]
    return host_decisions(cfg.particle_radius, cfg.dt, consts.ecoeff,
                          consts.friction, consts.drag_exp)


def decisions(consts: PhysicsConstants, cfg: StaticConfig) -> Decisions:
    """The frame's :class:`Decisions`: those its compiled frame made from
    the host values (``compiled.decided``), else of ``consts``, whose
    fields are then host floats."""
    d = compiled.decided()
    if d is not None:
        return d
    return host_decisions(cfg.particle_radius, cfg.dt, consts.ecoeff,
                          consts.friction, consts.drag_exp)


def frame_scalars(consts: PhysicsConstants, uin: UserInput,
                  cfg: StaticConfig, world_h: int, device) -> Scalars:
    """:class:`Scalars` of the consts vector on ``device``
    (``config.consts_vector``: one copy of host fields from pinned
    memory, or the lifted fields of a compiled frame stacked there)."""
    return Scalars.of(consts_vector(consts, uin, cfg, world_h,
                                    device=device))


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``.  A host tensor bound for the card goes through
    pinned memory without blocking (a pageable copy waits for the stream
    to drain); a compiled frame receives its host tensors on the device
    already (``compiled.py``), and a capture may not copy from the
    host."""
    device = torch.device(device)
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a captured frame copies no host tensor; "
                               "pass it as an argument (it is lifted)")
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def device_scalar(x: float, device) -> torch.Tensor:
    """A 0-d float32 tensor on ``device``.  Divide by this, not by a host
    scalar: on CUDA, torch turns ``t / host_scalar`` into a multiply by
    the reciprocal, which is not the division the kernels evaluate.
    Filled on the device (``torch.full``), not copied from the host: a
    blocking host-to-device copy would wait for the stream to drain."""
    return torch.full((), x, dtype=torch.float32, device=device)


# host constant arrays on their devices (device_constant)
_CONSTANTS: dict = {}


def device_constant(array: np.ndarray, device) -> torch.Tensor:
    """The host constant ``array`` (an offset table) on ``device``,
    copied at its first use and kept, keyed by its bytes: a captured
    frame may not copy from the host, and its eager warm-up makes the
    copy first."""
    device = torch.device(device)
    key = (array.dtype.str, array.shape, array.tobytes(), device)
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.as_tensor(array, device=device)
    return t


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
                extra_force=None, rsqrt: bool = False,
                rollgroup: bool = False):
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
    (compute.wgsl:127-130).

    ``rsqrt``: ``ln = d2·rsqrt(d2)`` and the force's ``1/ln`` is that
    ``rsqrt`` (``fused_substep2.py:593-600``).  ``rollgroup``: each class
    subtracts its own force in class order, a class with Δy = 0 adds its
    reaction at once, and the other reactions are added after the loop,
    grouped by Δy in the order each Δy first appears
    (``fused_substep2.py:646-658``)."""
    w, h = px.shape
    acc_t = torch.int32 if quantized else torch.float32
    fx = torch.zeros((w, h), dtype=acc_t, device=px.device)
    fy = torch.zeros((w, h), dtype=acc_t, device=px.device)
    if extra_force is not None:
        fx = fx + extra_force[0]
        fy = fy + extra_force[1]
    updates: List[SpringUpdate] = []
    deferred: dict = {}    # rollgroup: Δy -> [(fx, fy, dx)]
    for (dx, dy), e in zip(offsets, edges):
        active = e.alive & alive & shifted(alive, dx, dy, False)
        ddx = shifted(px, dx, dy) - px
        ddy = shifted(py, dx, dy) - py
        d2 = ddx * ddx + ddy * ddy
        zero = d2 == 0.0
        # zero-length guard (compute.wgsl:104-107): diff → (0, -1e-10)
        ddx = torch.where(zero, 0.0, ddx)
        ddy = torch.where(zero, -1.0e-10, ddy)
        if rsqrt:
            inv_len = torch.where(zero, 1.0e10, torch.rsqrt(d2))
            ln = torch.where(zero, 1.0e-10, d2 * inv_len)
        else:
            ln = torch.where(zero, 1.0e-10, sqrt32(d2))
            inv_len = torch.reciprocal(ln)

        fmag = (e.target_length - ln) * e.spring + (e.last_length - ln) * e.damp
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
            fvx = f32_to_i32(torch.trunc(fvx * PARTICLE_FORCE_SCALE))
            fvy = f32_to_i32(torch.trunc(fvy * PARTICLE_FORCE_SCALE))
        fx = fx - fvx
        fy = fy - fvy
        if rollgroup and dy != 0:
            deferred.setdefault(dy, []).append((fvx, fvy, dx))
        else:
            fx = fx + back(fvx, dx, dy)
            fy = fy + back(fvy, dx, dy)
    for dy, group in deferred.items():
        for gx, gy, dx in group:
            fx = fx + back(gx, dx, dy)
            fy = fy + back(gy, dx, dy)

    if quantized:
        fx = fx.to(torch.float32) / PARTICLE_FORCE_SCALE
        fy = fy.to(torch.float32) / PARTICLE_FORCE_SCALE
    return fx, fy, updates


def _stencil_collisions(px, py, vx, vy, alive, *, s: int, radius: float,
                        dt: float, ecoeff: float, friction: float,
                        rsqrt: bool = False, rollgroup: bool = False,
                        inv_dt2: bool = False):
    """Reference pair math over the half-offset stencil of radius ``s``.

    Each unordered pair is evaluated once at its lower endpoint and its
    exact negation applied to the partner, per offset in the order of
    :func:`half_offsets`: ``acc = (acc + t) - back(t)``.  The coincident
    nudge ``sign(lin_i − lin_j)`` is the per-offset constant
    ``−sign(dx·H + dy)``.  Returns (dvx, dvy, dax, day, dyn).

    ``rsqrt`` (``fused_substep2.py:736-745``): contact where ``0 < d2 <
    (2r)²``, ``inv = rsqrt(d2)``, ``dist = d2·inv``, and every term of a
    pair apart is +0.  ``rollgroup`` (``:764-786``): an offset with
    Δy ≠ 0 adds only its own term in the loop; its reaction joins the
    sum of its Δy's group (started from the group's first reaction), and
    after the loop each group is subtracted, in the order each Δy first
    appears in :func:`half_offsets` (1 … s, then −s … −1).

    The scalars are 0-d float32 tensors on the planes' device
    (``Scalars``): a tensor divisor divides exactly on every device.
    ``inv_dt2``: the penetration clip multiplies by ``1/(dt·dt)`` (float32)
    as the fused kernel K1 does (``fused_substep2.py:394``, ``:757``); by
    default it divides by ``dt·dt``, as the JAX stencil path
    (``ops/stencil.py:488``) and K4 do.  The two agree only where ``dt²``
    is a power of two."""
    w, h = px.shape
    two_r = 2.0 * radius
    two_r2 = two_r * two_r
    dt2 = dt * dt
    idt2 = torch.reciprocal(dt2)
    z = torch.zeros_like(px)
    dvx, dvy, dax, day, dyn = z, z, z, z, z
    groups: dict = {}     # rollgroup: Δy -> summed reactions
    for ox, oy in half_offsets(s):
        valid = alive & shifted(alive, ox, oy, False)
        ddx = shifted(px, ox, oy) - px
        ddy = shifted(py, ox, oy) - py
        d2 = ddx * ddx + ddy * ddy
        if rsqrt:
            coincident = valid & (d2 == 0.0)
            overlap = valid & (d2 > 0.0) & (d2 < two_r2)
            inv = torch.where(
                overlap, torch.rsqrt(torch.where(overlap, d2, 1.0)), 0.0)
            dist = d2 * inv
        else:
            dist = sqrt32(d2)
            coincident = valid & (dist == 0.0)
            overlap = valid & (dist > 0.0) & (dist < two_r)
            inv = torch.where(
                overlap, torch.reciprocal(torch.where(overlap, dist, 1.0)),
                0.0)

        co = torch.where(coincident, -float(np.sign(ox * h + oy)), 0.0)
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
        clip = ((two_r - dist) * 0.5 * idt2 if inv_dt2
                else (two_r - dist) * 0.5 / dt2)
        if rsqrt:
            pdax = torch.where(overlap, -nx * clip, 0.0)
            pday = torch.where(overlap, -ny * clip, 0.0)
        else:
            gate = overlap.to(torch.float32)
            pdax = -nx * clip * gate
            pday = -ny * clip * gate
        pdvx = torch.where(overlap, pdvx, 0.0)
        pdvy = torch.where(overlap, pdvy, 0.0)

        terms = (pdvx, pdvy, pdax, pday, co)
        acc = (dvx, dvy, dax, day, dyn)
        if rollgroup and oy != 0:
            acc = [a + t for a, t in zip(acc, terms)]
            react = [back(t, ox, oy) for t in terms]
            groups[oy] = (react if oy not in groups else
                          [g + r for g, r in zip(groups[oy], react)])
        else:
            acc = [a + t - back(t, ox, oy) for a, t in zip(acc, terms)]
        dvx, dvy, dax, day, dyn = acc
    for react in groups.values():
        dvx, dvy, dax, day, dyn = [a - r for a, r in zip(
            (dvx, dvy, dax, day, dyn), react)]
    return dvx, dvy, dax, day, dyn


def _integrate_components(px, py, vx, vy, ax, ay, alive, pinned,
                          dvx, dvy, dax, day, dyn, bfx, bfy, sc: Scalars,
                          rsqrt: bool = False):
    """Body forces, drag, user force, mouse grab, semi-implicit Euler and
    the border (compute.wgsl:171-199), on component planes.  ``rsqrt``
    (``fused_substep2.py:850-854``, ``:884-889``): ``1/speed`` is
    ``rsqrt(|v|²)`` and the grab test compares squared distances."""
    r = sc.radius
    p_x = px
    p_y = py + torch.where(alive, dyn, 0.0)
    v_x = vx + dvx
    v_y = vy + dvy
    a_x = ax + dax + sc.gx
    a_y = ay + day + sc.gy

    s2 = v_x * v_x + v_y * v_y
    moving = s2 > 0.0
    if rsqrt:
        inv_speed = torch.rsqrt(torch.where(moving, s2, 1.0))
    else:
        inv_speed = torch.reciprocal(torch.where(moving, sqrt32(s2), 1.0))
    a_x = a_x - torch.where(
        moving,
        sc.drag_coeff * tpow(v_x.abs(), sc.drag_exp) * v_x * inv_speed,
        0.0,
    )
    a_y = a_y - torch.where(
        moving,
        sc.drag_coeff * tpow(v_y.abs(), sc.drag_exp) * v_y * inv_speed,
        0.0,
    )

    a_x = a_x + sc.force_x * sc.user_strength
    a_y = a_y + sc.force_y * sc.user_strength

    mdx = sc.mouse_px - p_x
    mdy = sc.mouse_py - p_y
    grab_r = r * 10.0
    if rsqrt:
        near = mdx * mdx + mdy * mdy < grab_r * grab_r
    else:
        near = sqrt32(mdx * mdx + mdy * mdy) < grab_r
    grabbed = near & (sc.mouse_active > 0.0)
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

    lo, hi = r, sc.bounds - r
    cx_ = torch.clamp(p_x, lo, hi)
    cy_ = torch.clamp(p_y, lo, hi)
    hit_x = p_x != cx_
    hit_y = p_y != cy_
    be = sc.border_elasticity
    bf = sc.border_friction
    one_be = 1.0 + be

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
                   extra_force=None, rsqrt: bool = False,
                   rollgroup: bool = False, inv_dt2: bool = False,
                   k3_skip: Optional[bool] = None):
    """One substep on component planes: springs (``spring_pass`` over
    ``offsets``, ``extra_force`` first), collisions, each of the
    ``far_deltas`` (``[5, W, H]`` stacks of dvx dvy dax day dyn, or
    None) in turn, integration.  ``full_stencil``: the collisions go
    through the K3 wrapper (``ops/cuda/collide_stencil.py``, full offset
    set) instead of the half-offset sum; K3 reads the constants from
    ``sc.vec`` on the card, with its skip decided on the host
    (``k3_skip``, :class:`Decisions`).  ``rsqrt``/``rollgroup``: the
    fused kernel K1's arithmetic variants (half-offset collisions only);
    ``inv_dt2``: K1's penetration clip (``_stencil_collisions``).
    Returns the six new particle planes and the spring updates."""
    if full_stencil and (rsqrt or rollgroup):
        raise ValueError("the kernel variants apply to the half-offset "
                         "collisions only")
    bfx, bfy, ups = spring_pass(px, py, alive, edges, quantized, offsets,
                                extra_force, rsqrt=rsqrt,
                                rollgroup=rollgroup)
    kw = dict(radius=sc.radius, dt=sc.dt, ecoeff=sc.ecoeff,
              friction=sc.friction)
    if stencil == 0:
        z = torch.zeros_like(px)
        dvx = dvy = dax = day = dyn = z
    elif full_stencil:
        from .cuda.collide_stencil import collide_stencil_call

        dvx, dvy, dax, day, dyn = collide_stencil_call(
            px, py, vx, vy, alive, stencil=stencil, consts=sc.vec,
            skip=k3_skip, **kw)
    else:
        dvx, dvy, dax, day, dyn = _stencil_collisions(
            px, py, vx, vy, alive, s=stencil, rsqrt=rsqrt,
            rollgroup=rollgroup, inv_dt2=inv_dt2, **kw)
    for fd in far_deltas:
        if fd is None:
            continue
        dvx = dvx + fd[0]
        dvy = dvy + fd[1]
        dax = dax + fd[2]
        day = day + fd[3]
        dyn = dyn + fd[4]
    planes = _integrate_components(px, py, vx, vy, ax, ay, alive, pinned,
                                   dvx, dvy, dax, day, dyn, bfx, bfy, sc,
                                   rsqrt=rsqrt)
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
    scalars: Optional[Scalars] = None,
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
    (``softbody_tpu/parallel/lattice_spatial.py:66-71``).
    ``scalars``: the consts vector's :class:`Scalars` on the state's
    device where the caller has them (a frame forms them once; the port's
    addition), else formed here (:func:`frame_scalars`)."""
    sc = (frame_scalars(consts, uin, cfg, spec.height, state.pos.device)
          if scalars is None else scalars)
    # K3's skip, decided on the host (only K3 needs it)
    k3_skip = decisions(consts, cfg).k3_skip if cfg.use_pallas else None
    collide = cfg.collision_mode != "none"
    px, py = state.pos[..., 0], state.pos[..., 1]
    vx, vy = state.vel[..., 0], state.vel[..., 1]
    far_terms = None
    if far is not None and collide:
        from .farfield import far_collision_terms

        far_terms = far_collision_terms(
            px, py, vx, vy, state.alive, far, s=spec.collision_stencil,
            ff=ffspec, radius=cfg.particle_radius, dt=cfg.dt,
            ecoeff=sc.ecoeff, friction=sc.friction, world_h=spec.height)
    (pxn, pyn, vxn, vyn, axn, ayn), ups = substep_planes(
        px, py, vx, vy, state.acc[..., 0], state.acc[..., 1],
        state.alive, state.pinned, state.edges, sc,
        stencil=spec.collision_stencil if collide else 0,
        quantized=cfg.force_mode == "quantized",
        far_deltas=(far_delta if collide else None, far_terms),
        full_stencil=cfg.use_pallas,
        offsets=spec.edge_offsets,
        extra_force=extra_force,
        k3_skip=k3_skip,
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
    sc = frame_scalars(consts, uin, cfg, spec.height, state.pos.device)
    for _ in range(n):
        state = lattice_substep(state, consts, uin, spec, cfg, scalars=sc)
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
    sc = frame_scalars(consts, uin, cfg, spec.height, state.pos.device)
    for _ in range(n):
        state = lattice_substep(state, consts, uin, spec, cfg, far=far,
                                ffspec=ffspec, scalars=sc)
    return state


lattice_frame_jit = Compiled(lattice_frame,
                             static_argnames=("spec", "cfg", "n_sub"),
                             decide=frame_decisions)

lattice_frame_far_jit = Compiled(
    lattice_frame_far, static_argnames=("spec", "cfg", "ffspec", "n_sub"),
    decide=frame_decisions)

lattice_substep_jit = Compiled(lattice_substep,
                               static_argnames=("spec", "cfg", "ffspec"),
                               decide=frame_decisions)
