"""Plain PyTorch reference of the softbody world's physics.

The semantics are those of the reference WebGPU app's compute shader
(compute.wgsl): every beam a spring with yield and breakage, every pair
of live particles closer than two radii in contact, semi-implicit Euler
and the border.  The world is flat: particles ``[N]`` and beams ``[M]``
(endpoints ``a``, ``b``), with no lattice, stencil, embedding or far
list.  Contacts are found by a uniform grid of cell side ``2r``, so each
particle meets every partner in contact, whatever their distance in
index space.  Each ordered pair ``(i, j)`` adds its terms to ``i`` only;
the pair math is antisymmetric, so ``(j, i)`` adds the exact negation to
``j``.

Spring forces accumulate in int32 at scale 65536 (the app's atomic
trick; ``force_mode="quantized"``), so their sums do not depend on the
order.  Float arithmetic is in ``dtype``: float32 is the reference, and
a lower precision (bfloat16) is the control that the check has to fail.
Nothing here imports the program under test.
"""

from __future__ import annotations

import dataclasses

import torch

FORCE_SCALE = 65536.0


@dataclasses.dataclass(frozen=True)
class Consts:
    """One world's constants (the app's metadata buffer and the static
    configuration).  Floats are float32 values held as host floats."""

    radius: float
    dt: float
    bounds: float
    gravity: tuple
    border_elasticity: float
    border_friction: float
    elasticity: float
    friction: float
    drag_coeff: float
    drag_exp: float
    subticks: int

    @property
    def ecoeff(self) -> float:
        e = torch.tensor(self.elasticity, dtype=torch.float32)
        return float((e + 1.0) * 0.5)


@dataclasses.dataclass
class World:
    """Flat world state.  ``lin`` orders the particles (the coincident
    nudge pushes the lower index down)."""

    pos: torch.Tensor           # [N, 2]
    vel: torch.Tensor           # [N, 2]
    acc: torch.Tensor           # [N, 2]
    alive: torch.Tensor         # [N] bool
    pinned: torch.Tensor        # [N] bool
    lin: torch.Tensor           # [N] int64
    a: torch.Tensor             # [M] int64
    b: torch.Tensor             # [M] int64
    length: torch.Tensor        # [M]
    target: torch.Tensor        # [M]
    last: torch.Tensor          # [M]
    spring: torch.Tensor        # [M]
    damp: torch.Tensor          # [M]
    yield_strain: torch.Tensor  # [M]
    strain_limit: torch.Tensor  # [M]
    beam_alive: torch.Tensor    # [M] bool

    FLOATS = ("pos", "vel", "acc", "length", "target", "last", "spring",
              "damp", "yield_strain", "strain_limit")

    def to(self, dtype) -> "World":
        """The world with every float field in ``dtype``."""
        return dataclasses.replace(self, **{
            k: getattr(self, k).to(dtype) for k in self.FLOATS})

    def replace(self, **kw) -> "World":
        return dataclasses.replace(self, **kw)


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """Truncated float → int32, saturating (NaN → 0), as the GPU's
    ``cvt.rzi.sat``."""
    x = torch.nan_to_num(x.to(torch.float32), nan=0.0, posinf=3.0e9,
                         neginf=-3.0e9)
    top = x >= 2147483648.0
    v = x.clamp(-2147483648.0, 2147483520.0).to(torch.int32)
    return torch.where(top, torch.full_like(v, 2147483647), v)


def springs(w: World):
    """Spring forces ``[N]`` x/y and the beams' new target length, last
    length and liveness (compute.wgsl:96-131)."""
    pa, pb = w.pos[w.a], w.pos[w.b]
    active = w.beam_alive & w.alive[w.a] & w.alive[w.b]
    ddx = pb[:, 0] - pa[:, 0]
    ddy = pb[:, 1] - pa[:, 1]
    d2 = ddx * ddx + ddy * ddy
    zero = d2 == 0.0
    ddx = torch.where(zero, 0.0, ddx)
    ddy = torch.where(zero, -1.0e-10, ddy)
    ln = torch.where(zero, 1.0e-10, torch.sqrt(d2))
    inv = torch.reciprocal(ln)
    fmag = (w.target - ln) * w.spring + (w.last - ln) * w.damp
    fvx = torch.where(active, fmag * ddx * inv, 0.0)
    fvy = torch.where(active, fmag * ddy * inv, 0.0)
    strain = (ln - w.target) / w.length
    yielded = strain.abs() > w.yield_strain
    new_target = torch.where(
        yielded, ln - w.yield_strain * w.length * torch.sign(strain),
        w.target)
    breaks = (ln - w.length).abs() > w.length * w.strain_limit
    target = torch.where(active, new_target, w.target)
    last = torch.where(active, ln, w.last)
    alive = w.beam_alive & ~(active & breaks)
    n = w.pos.shape[0]
    qx = _to_i32(torch.trunc(fvx * FORCE_SCALE))
    qy = _to_i32(torch.trunc(fvy * FORCE_SCALE))
    fx = torch.zeros(n, dtype=torch.int32, device=w.pos.device)
    fy = torch.zeros(n, dtype=torch.int32, device=w.pos.device)
    fx.index_add_(0, w.a, -qx)
    fx.index_add_(0, w.b, qx)
    fy.index_add_(0, w.a, -qy)
    fy.index_add_(0, w.b, qy)
    dt = w.pos.dtype
    return ((fx.to(torch.float32) / FORCE_SCALE).to(dt),
            (fy.to(torch.float32) / FORCE_SCALE).to(dt), target, last, alive)


def _grid(px, py, alive, cell: float):
    """Cell keys of a grid of side ``cell``, sorted; dead particles get
    the key −1 and no partner."""
    ix = torch.floor(px.to(torch.float32) / cell).to(torch.int64)
    iy = torch.floor(py.to(torch.float32) / cell).to(torch.int64)
    ix = ix - int(ix.min()) + 1
    iy = iy - int(iy.min()) + 1
    rows = int(iy.max()) + 2
    key = torch.where(alive, ix * rows + iy, -1)
    skey, order = torch.sort(key)
    _, counts = torch.unique_consecutive(skey, return_counts=True)
    return key, skey, order, rows, int(counts.max())


def contacts(w: World, c: Consts, near=None, block_elems: int = 1 << 24):
    """Every live pair closer than ``2r`` (and coincident pairs): per
    particle the sums of the pair terms (compute.wgsl:150-168) → ``dvx,
    dvy, dax, day, dyn`` ``[N]``.  Partners are the particles of the
    3 × 3 cells around a particle's own, in blocks of particles so that
    a block's ``[B, 9·M]`` pair planes stay near ``block_elems``.

    ``near = (s, h)`` keeps only the pairs of a lattice's collision
    stencil: particles ``x·h + y`` (by ``lin``) at most ``s`` apart in
    ``x`` and in ``y``.  That world has no contact across the sheet, and
    holds the far contacts' share of a frame apart."""
    px, py = w.pos[:, 0], w.pos[:, 1]
    vx, vy = w.vel[:, 0], w.vel[:, 1]
    n = px.shape[0]
    dt_ = px.dtype
    dev = px.device
    two_r = torch.tensor(2.0 * c.radius, dtype=torch.float32).item()
    key, skey, order, rows, m = _grid(px, py, w.alive, two_r)
    offs = torch.tensor([ox * rows + oy for ox in (-1, 0, 1)
                         for oy in (-1, 0, 1)], device=dev)
    ar = torch.arange(m, device=dev)
    dt2 = torch.tensor(c.dt, dtype=torch.float32) ** 2
    two_r_t = torch.tensor(two_r, dtype=dt_, device=dev)
    dt2_t = dt2.to(dt_).to(dev)
    ecoeff, friction = c.ecoeff, c.friction
    out = torch.zeros((5, n), dtype=dt_, device=dev)
    step = max(1, block_elems // (9 * m))
    for lo in range(0, n, step):
        i = torch.arange(lo, min(n, lo + step), device=dev)
        nk = key[i][:, None] + offs[None, :]
        st = torch.searchsorted(skey, nk)
        en = torch.searchsorted(skey, nk, right=True)
        idx = st[..., None] + ar
        ok = (idx < en[..., None]) & (key[i] >= 0)[:, None, None]
        j = order[idx.clamp(max=n - 1)].reshape(i.shape[0], -1)
        ok = ok.reshape(i.shape[0], -1)
        ii = i[:, None]
        valid = ok & (j != ii) & w.alive[j]
        if near is not None:
            s, h = near
            li, lj = w.lin[ii], w.lin[j]
            valid = valid & ((li // h - lj // h).abs() <= s) & (
                (li % h - lj % h).abs() <= s)
        ddx = px[j] - px[ii]
        ddy = py[j] - py[ii]
        dist = torch.sqrt(ddx * ddx + ddy * ddy)
        coincident = valid & (dist == 0.0)
        overlap = valid & (dist > 0.0) & (dist < two_r_t)
        co = torch.where(coincident,
                         torch.sign(w.lin[ii] - w.lin[j]).to(dt_), 0.0)
        inv = torch.where(overlap,
                          torch.reciprocal(torch.where(overlap, dist, 1.0)),
                          0.0)
        nx, ny = ddx * inv, ddy * inv
        rvx = vx[ii] - vx[j]
        rvy = vy[ii] - vy[j]
        imp_n = ecoeff * (rvx * nx + rvy * ny)
        max_fric = imp_n * friction
        imp_t = torch.minimum(torch.maximum(rvx * -ny + rvy * nx, -max_fric),
                              max_fric)
        pdvx = torch.where(overlap, -(imp_n * nx + imp_t * -ny), 0.0)
        pdvy = torch.where(overlap, -(imp_n * ny + imp_t * nx), 0.0)
        clip = (two_r_t - dist) * 0.5 / dt2_t
        pdax = torch.where(overlap, -nx * clip, 0.0)
        pday = torch.where(overlap, -ny * clip, 0.0)
        for k, t in enumerate((pdvx, pdvy, pdax, pday, co)):
            out[k, lo:lo + i.shape[0]] = t.sum(dim=1)
    return tuple(out[k] for k in range(5))


def integrate(w: World, c: Consts, dvx, dvy, dax, day, dyn, bfx, bfy):
    """Body forces, drag, semi-implicit Euler and the border
    (compute.wgsl:171-199); no user input (no mouse, no applied force).
    Returns the new ``pos``, ``vel``, ``acc``."""
    r = c.radius
    px, py = w.pos[:, 0], w.pos[:, 1]
    vx, vy = w.vel[:, 0], w.vel[:, 1]
    ax, ay = w.acc[:, 0], w.acc[:, 1]
    alive = w.alive
    p_x = px
    p_y = py + torch.where(alive, dyn, 0.0)
    v_x = vx + dvx
    v_y = vy + dvy
    a_x = ax + dax + c.gravity[0]
    a_y = ay + day + c.gravity[1]
    s2 = v_x * v_x + v_y * v_y
    moving = s2 > 0.0
    inv_speed = torch.reciprocal(torch.where(moving, torch.sqrt(s2), 1.0))
    a_x = a_x - torch.where(
        moving, c.drag_coeff * torch.pow(v_x.abs(), c.drag_exp) * v_x
        * inv_speed, 0.0)
    a_y = a_y - torch.where(
        moving, c.drag_coeff * torch.pow(v_y.abs(), c.drag_exp) * v_y
        * inv_speed, 0.0)
    a_x = a_x + bfx
    a_y = a_y + bfy
    v_x = v_x + a_x * c.dt
    v_y = v_y + a_y * c.dt
    p_x = p_x + v_x * c.dt
    p_y = p_y + v_y * c.dt
    lo, hi = r, c.bounds - r
    cx_ = torch.clamp(p_x, lo, hi)
    cy_ = torch.clamp(p_y, lo, hi)
    hit_x = p_x != cx_
    hit_y = p_y != cy_
    be, bf = c.border_elasticity, c.border_friction
    one_be = 1.0 + be
    fric_y = torch.sign(v_y) * bf * v_x.abs() * one_be
    na_y = torch.where(hit_x, 0.0 - torch.clamp(fric_y, max=0.0), 0.0)
    nv_x = torch.where(hit_x, v_x * -be, v_x)
    fric_x = torch.sign(nv_x) * bf * v_y.abs() * one_be
    na_x = torch.where(hit_y, 0.0 - torch.clamp(fric_x, max=0.0), 0.0)
    nv_y = torch.where(hit_y, v_y * -be, v_y)
    keep = alive & ~w.pinned
    pos = torch.stack([torch.where(keep, cx_, px),
                       torch.where(keep, cy_, py)], -1)
    vel = torch.stack([torch.where(keep, nv_x, vx),
                       torch.where(keep, nv_y, vy)], -1)
    acc = torch.stack([torch.where(keep, na_x, ax),
                       torch.where(keep, na_y, ay)], -1)
    return pos, vel, acc


def substep(w: World, c: Consts, near=None) -> World:
    """One substep: springs, contacts (``near``: see :func:`contacts`)
    and integration, all read from the substep's starting state."""
    bfx, bfy, target, last, balive = springs(w)
    dvx, dvy, dax, day, dyn = contacts(w, c, near)
    pos, vel, acc = integrate(w, c, dvx, dvy, dax, day, dyn, bfx, bfy)
    return w.replace(pos=pos, vel=vel, acc=acc, target=target, last=last,
                     beam_alive=balive)


def frame(w: World, c: Consts, dtype=torch.float32, near=None) -> World:
    """One frame (``c.subticks`` substeps) in ``dtype``; the result in
    float32.  ``near``: see :func:`contacts`."""
    w = w.to(dtype)
    for _ in range(c.subticks):
        w = substep(w, c, near)
    return w.to(torch.float32)
